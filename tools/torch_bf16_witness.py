"""How far a bfloat16 training step of the port's DataParallelTrainer can
be held against float64, and which measures of it can tell a wrong step
from a right one.

ResNet-50 v1 (``chip_smoke.resnet_v1_symbol``) at 224 x 224, bench.py's
SGD (lr 0.05, momentum 0.9, rescale_grad 1 / batch), from two sets of
parameters: He-normal (``chip_smoke._init_bound``, as ``module_resnet50``
checks the executor) and the trainer's own draw (``init_state``: N(0,
0.01), as bench.py trains). For each of them and each batch in BATCHES:
one step of the trainer in bfloat16 (fp32 masters) and in float32 on the
card, and in bfloat16 on the CPU where the batch is in CPU_BATCHES, each
against the float64 step of the executor on the card (which
``chip_smoke.py``'s ``module_resnet50`` holds against the CPU's float64
step). The measures, over the momentum after the step (-lr x rescale x
the gradient) of each parameter:

* ``norm_err``: ||m - m64|| / ||m64||, median and largest over the tensors
  (the rule the float32 step is held by);
* ``cos``: the cosine of m and m64, median and smallest; ``cos_all`` over
  all parameters as one vector;
* ``log_ratio``: |log(||m|| / ||m64||)|, median and largest;
* ``ce_rel``: the cross-entropy of the output's probabilities at the
  labels, relative to float64's.

The same measures of four faults of the bfloat16 step on the card: its
momenta zeroed, negated and doubled, and the step taken with the labels
rolled by one sample. Then ``TRAJ_STEPS`` steps on one batch of
``TRAJ_BATCH``, the cross-entropy before each: float32, bfloat16, and
bfloat16 at lr 0 and at -lr.

Run from the repository root on a machine with a CUDA card:
``python3 tools/torch_bf16_witness.py``. One JSON object a line.
"""
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402

BATCHES = (2, 8, 32)
CPU_BATCHES = (2, 8)
TRAJ_BATCH = 8
TRAJ_STEPS = 10
CARD = "cuda"           # "cpu" rehearses the script at a small R50_IMG


def _trainer_step(sym, dtype, device, shape, args, auxs, x, y):
    b = shape[0]
    tr = cs._dp_trainer(sym, dtype, b, device)
    p, st, a = tr.init_state({"data": shape, "softmax_label": (b,)},
                             arg_params=args, aux_params=auxs)
    p, st, a, _, outs = tr.step(p, st, a, tr.shard_inputs([x, y]))
    got = {"output": outs[0].float().cpu().numpy().astype(np.float64)}
    got.update({"mom:" + n: s_[0].cpu().numpy().astype(np.float64)
                for n, s_ in zip(tr.param_names, st)})
    del tr, p, st, a
    cs._free_card()
    return got


def _params(sym, init, shape):
    if init == "he_normal":
        host = sym.simple_bind(ctx=mx.cpu(), data=shape)
        cs._init_bound(host, mx, cs.SEED)
        return ({n: a.asnumpy() for n, a in host.arg_dict.items()
                 if n not in ("data", "softmax_label")},
                {n: a.asnumpy() for n, a in host.aux_dict.items()})
    tr = cs._dp_trainer(sym, "float32", shape[0], "cpu")
    p, _, a = tr.init_state({"data": shape, "softmax_label": shape[:1]})
    return tr.host_params(p), tr.host_aux(a)


def one_step(sym, b, init):
    shape = (b, 3, cs.R50_IMG, cs.R50_IMG)
    rng = np.random.RandomState(cs.SEED)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = rng.randint(0, 1000, b).astype(np.float32)
    args, auxs = _params(sym, init, shape)
    t0 = time.perf_counter()
    ref = cs._dp_reference(sym, shape, args, auxs, x, y,
                           mx.gpu(0) if CARD == "cuda" else mx.cpu())
    row = {"batch": b, "init": init, "reference": "float64 on the card",
           "reference_s": time.perf_counter() - t0}
    bf = _trainer_step(sym, "bfloat16", CARD, shape, args, auxs, x, y)
    row["card_bf16"] = cs._step_measures(bf, ref, y)
    row["card_f32"] = cs._step_measures(
        _trainer_step(sym, "float32", CARD, shape, args, auxs, x, y),
        ref, y)
    if b in CPU_BATCHES:
        t0 = time.perf_counter()
        row["cpu_bf16"] = cs._step_measures(
            _trainer_step(sym, "bfloat16", "cpu", shape, args, auxs, x, y),
            ref, y)
        row["cpu_bf16_s"] = time.perf_counter() - t0
    faults = {"zeroed": 0.0, "negated": -1.0, "doubled": 2.0}
    for name, f in faults.items():
        got = {k: (v * f if k.startswith("mom:") else v)
               for k, v in bf.items()}
        row["fault_" + name] = cs._step_measures(got, ref, y)
    row["fault_labels_rolled"] = cs._step_measures(
        _trainer_step(sym, "bfloat16", CARD, shape, args, auxs, x,
                      np.roll(y, 1)), ref, y)
    return row


def trajectory(sym):
    b = TRAJ_BATCH
    shape = (b, 3, cs.R50_IMG, cs.R50_IMG)
    rng = np.random.RandomState(cs.SEED)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = rng.randint(0, 1000, b).astype(np.float32)
    out = {"batch": b, "steps": TRAJ_STEPS}
    for tag, dtype, lr in (("f32", "float32", cs.R50_LR),
                           ("bf16", "bfloat16", cs.R50_LR),
                           ("bf16_lr0", "bfloat16", 0.0),
                           ("bf16_neg_lr", "bfloat16", -cs.R50_LR)):
        tr = cs._dp_trainer(sym, dtype, b, CARD)
        tr.set_learning_rate(lr)
        state = tr.init_state({"data": shape, "softmax_label": (b,)})
        inputs = tr.shard_inputs([x, y])
        ces = []
        for _ in range(TRAJ_STEPS):
            p, st, a, _, outs = tr.step(*state, inputs)
            state = (p, st, a)
            ces.append(cs._ce(outs[0].float().cpu().numpy(), y))
        out[tag] = ces
        del tr, state, p, st, a
        cs._free_card()
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi(),
                      "torch": torch.__version__}), flush=True)
    with mx.NameManager():
        sym = cs.resnet_v1_symbol(mx.sym)
    for init in ("init_state", "he_normal"):
        for b in BATCHES:
            print(json.dumps(one_step(sym, b, init)), flush=True)
    print(json.dumps({"trajectory": trajectory(sym)}), flush=True)


if __name__ == "__main__":
    main()
