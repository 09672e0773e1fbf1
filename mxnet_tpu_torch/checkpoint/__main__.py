"""The checkpoint selftest: a crash-injection proof of the commit
protocol (counterpart of ``python -m mxnet_tpu.checkpoint``).

    python -m mxnet_tpu_torch.checkpoint --selftest [--fused] [--ctx cpu]

One JSON line, exit 0 iff everything holds:

  1. the manager in-process: atomic save and restore, keep-last-N with
     best-k retention, a corrupt newest commit falling back a step, the
     counters;
  2. crash injection: a seeded MLP ``Module.fit(checkpoint_dir=...)``
     victim in a subprocess is SIGKILLed at an exact instant of its
     step-15 commit (``MXNET_CHECKPOINT_INJECT_CRASH``); the newest
     committed checkpoint must restore, and ``fit(..., resume=True)``
     must end with parameters bit-identical (sha256) to an uninterrupted
     run's.

``--fused`` runs the victims through ``steps_per_dispatch=2`` (the
``DataParallelTrainer`` and its device scalars). The victims train on
the card unless ``--ctx cpu``. ``--victim`` is the subprocess's entry
point. The JAX package's ``--elastic`` lane (a restore in processes of
another device count) needs several processes a job, which the port does
not run yet (ROADMAP queue 1 item 16); it exits 2 saying so.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile


def _mlp_sym(mx):
    with mx.NameManager():
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                    name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def _params_sha256(mod):
    import numpy as np
    args, auxs = mod.get_params()
    h = hashlib.sha256()
    for d in (args, auxs):
        for name in sorted(d):
            h.update(name.encode("utf-8"))
            h.update(np.ascontiguousarray(d[name].asnumpy()).tobytes())
    return h.hexdigest()


# 5 batches/epoch x 6 epochs -> epoch-boundary commits at steps
# 5,10,15,20,25,30; the selftest injects its crash at the step-15 commit
_SAMPLES, _BATCH, _EPOCHS, _CRASH_STEP = 40, 8, 6, 15


def victim(args):
    """The subprocess's entry point: a seeded, deterministic fit that
    commits a checkpoint at every epoch end and prints the sha256 of its
    final parameters."""
    import numpy as np
    import mxnet_tpu_torch as mx
    if args.ctx == "gpu":
        import torch
        torch.backends.cudnn.deterministic = True
    np.random.seed(0)
    mx.random.seed(0)
    rng = np.random.RandomState(42)
    X = rng.normal(size=(_SAMPLES, 8)).astype(np.float32)
    Y = rng.randint(0, 4, size=(_SAMPLES,)).astype(np.float32)
    ctx = mx.cpu(0) if args.ctx == "cpu" else mx.gpu(0)
    it = mx.io.NDArrayIter(mx.nd.array(X, ctx=ctx), mx.nd.array(Y, ctx=ctx),
                           batch_size=_BATCH, shuffle=False)
    mod = mx.mod.Module(_mlp_sym(mx), context=ctx)
    mod.fit(it, num_epoch=args.epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(rnd_type="gaussian"),
            eval_metric="acc",
            steps_per_dispatch=2 if args.fused else 1,
            checkpoint_dir=args.victim, resume=args.resume)
    print(json.dumps({"metric": "checkpoint_victim",
                      "sha256": _params_sha256(mod), "ok": True}),
          flush=True)
    return 0


def _run_victim(ckpt_dir, ctx, resume=False, fused=False, crash=None,
                extra_env=None):
    env = dict(os.environ)
    env.pop("MXNET_CHECKPOINT_INJECT_CRASH", None)
    if crash:
        env["MXNET_CHECKPOINT_INJECT_CRASH"] = crash
    if extra_env:
        env.update(extra_env)
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.checkpoint",
           "--victim", ckpt_dir, "--epochs", str(_EPOCHS), "--ctx", ctx]
    if resume:
        cmd.append("--resume")
    if fused:
        cmd.append("--fused")
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)


def _json_rec(proc, metric):
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if rec.get("metric") == metric:
            return rec
    return None


def _victim_sha(proc):
    rec = _json_rec(proc, "checkpoint_victim")
    return rec["sha256"] if rec else None


def _payload_file(step_dir):
    """Some shard's arrays payload inside a committed step dir — the
    file the corruption/missing-shard checks target."""
    for root, _, files in sorted(os.walk(step_dir)):
        for f in sorted(files):
            if f.startswith("arrays"):
                return os.path.join(root, f)
    raise FileNotFoundError(f"no arrays payload under {step_dir}")


def _protocol_checks(tmp, results):
    """Fast in-process checks of the manager itself (numpy payloads —
    no mesh/training needed)."""
    import numpy as np
    from mxnet_tpu_torch.checkpoint import CheckpointManager, TrainingState

    mgr = CheckpointManager(os.path.join(tmp, "proto"), keep_last_n=2,
                            keep_best_k=1, async_save=True)
    for s, m in [(1, 0.1), (2, 0.5), (3, 0.3), (4, 0.2), (5, 0.4)]:
        mgr.save(TrainingState(
            arrays={"param:w": np.full((4,), s, np.float32)},
            meta={"epoch": s, "batch": 0, "step": s}), step=s, metric=m)
    mgr.wait()
    # last 2 by recency (4, 5) plus best 1 by metric (2, metric 0.5)
    results["retention_kept"] = mgr.steps()
    results["retention_ok"] = mgr.steps() == [2, 4, 5]
    st = mgr.restore()
    results["roundtrip_ok"] = bool(
        st is not None and st.step == 5
        and np.array_equal(st.arrays["param:w"],
                           np.full((4,), 5, np.float32)))
    # corrupt the newest payload (inside its shard dir): restore must
    # fall back to step 4
    with open(_payload_file(os.path.join(mgr.directory,
                                         mgr._step_dirname(5))),
              "r+b") as f:
        f.write(b"garbage")
    st = mgr.restore()
    results["corrupt_falls_back"] = bool(st is not None and st.step == 4)
    mgr.close()
    c = mgr.counters()
    results["counters_ok"] = bool(c["ckpt_commits"] == 5
                                  and c["ckpt_bytes"] > 0
                                  and c["ckpt_save_us"] > 0)
    return (results["retention_ok"] and results["roundtrip_ok"]
            and results["corrupt_falls_back"] and results["counters_ok"])


def selftest(points, fused=False, ctx="gpu"):
    results = {"metric": "checkpoint_selftest", "fused": bool(fused),
               "ctx": ctx}
    ok = True
    with tempfile.TemporaryDirectory(prefix="ckpt_selftest_") as tmp:
        ok &= _protocol_checks(tmp, results)

        base = _run_victim(os.path.join(tmp, "baseline"), ctx, fused=fused)
        base_sha = _victim_sha(base)
        results["baseline_ok"] = bool(base.returncode == 0 and base_sha)
        if not results["baseline_ok"]:
            results["baseline_stderr"] = base.stderr[-2000:]
            results["ok"] = False
            print(json.dumps(results), flush=True)
            return 1

        from mxnet_tpu_torch.checkpoint import CheckpointManager
        for point in points:
            tag = point.replace("-", "_")
            d = os.path.join(tmp, tag)
            crashed = _run_victim(d, ctx, fused=fused,
                                  crash=f"{point}@{_CRASH_STEP}")
            killed = crashed.returncode in (-9, 137)
            results[f"{tag}_killed"] = bool(killed)
            mgr = CheckpointManager(d)
            latest = mgr.latest_step()
            # pre-rename/mid-arrays die before the step-15 commit lands:
            # newest committed is 10; post-rename dies after: 15
            want = _CRASH_STEP if point == "post-rename" \
                else _CRASH_STEP - 5
            results[f"{tag}_latest"] = latest
            restorable = mgr.restore() is not None
            mgr.close()
            results[f"{tag}_restorable"] = bool(restorable)
            resumed = _run_victim(d, ctx, resume=True, fused=fused)
            sha = _victim_sha(resumed)
            results[f"{tag}_resume_ok"] = bool(resumed.returncode == 0
                                               and sha)
            results[f"{tag}_bit_identical"] = bool(sha == base_sha)
            point_ok = (killed and latest == want and restorable
                        and sha == base_sha)
            if not point_ok and resumed.stderr:
                results[f"{tag}_stderr"] = resumed.stderr[-2000:]
            ok &= point_ok
    results["ok"] = bool(ok)
    print(json.dumps(results), flush=True)
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.checkpoint")
    ap.add_argument("--selftest", action="store_true",
                    help="run protocol + crash-injection checks "
                         "(ci.sh quick)")
    ap.add_argument("--points", default="mid-arrays,post-rename",
                    help="comma-separated crash points for --selftest "
                         "(mid-arrays, pre-rename, post-rename)")
    ap.add_argument("--fused", action="store_true",
                    help="run the victim through the fused "
                         "steps_per_dispatch>1 path")
    ap.add_argument("--elastic", action="store_true",
                    help="(the JAX package's lane across device counts: "
                         "not available)")
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"],
                    help="where the victims train (default: the card)")
    ap.add_argument("--victim", metavar="DIR",
                    help="(internal) run the training victim with "
                         "checkpoint_dir=DIR")
    ap.add_argument("--epochs", type=int, default=_EPOCHS)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    if args.victim:
        return victim(args)
    if args.elastic:
        print("checkpoint --elastic restores in processes pinned to another "
              "device count; the port runs one process a job (ROADMAP "
              "queue 1 item 16)", file=sys.stderr)
        return 2
    if not args.selftest:
        ap.print_help()
        return 2
    return selftest([p.strip() for p in args.points.split(",")
                     if p.strip()], fused=args.fused, ctx=args.ctx)


if __name__ == "__main__":
    sys.exit(main())
