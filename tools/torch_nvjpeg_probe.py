#!/usr/bin/env python3
"""How far nvJPEG's decode lies from the JAX package's, by nvJPEG flag.

    python3 tools/torch_nvjpeg_probe.py        (on a machine with a card)

Decodes the committed JPEG fixture (tests/data/jpeg_fixture.npz: JPEGs
beside the JAX package's OpenCV decode of each) with nvJPEG through the
port's codec (image/codec.py), once with nvJPEG's default chroma
upsampling and once with NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION (the
codec's setting), and prints the mean and largest |difference| of each,
with nvJPEG's answer to a request for the hardware decoder (0: granted;
7: ARCH_MISMATCH). Where OpenCV is installed it does the same for 32 of
bench.py's synthetic 256² JPEGs at quality 90. One JSON line; the card's
name and power limit before it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _cases():
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.test_utils import jpeg_fixture
    out = {"fixture": [(recordio.unpack(r)[1], pix) for r, pix in
                       jpeg_fixture(os.path.join(HERE, "tests", "data",
                                                 "jpeg_fixture.npz"))]}
    try:
        import cv2
    except ImportError:
        return out
    rng = np.random.RandomState(0)
    synth = []
    for _ in range(32):
        base = rng.randint(0, 255, (8, 8, 3), np.uint8)
        img = cv2.resize(base, (256, 256), interpolation=cv2.INTER_CUBIC)
        img = np.clip(img.astype(np.int16) + rng.randint(-10, 10, img.shape),
                      0, 255).astype(np.uint8)
        buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1]
        synth.append((buf.tobytes(), cv2.imdecode(buf, 1)))
    out["bench_synthetic"] = synth
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_nvjpeg_probe: no CUDA device", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.image import codec
    dev = torch.device("cuda")
    res = {}
    for name, flags in (("default", 0), ("interpolation", 1 << 5)):
        codec.FLAGS = flags
        codec._LOCAL.__dict__.clear()        # new contexts with the flag
        res[name] = {}
        for case, entries in _cases().items():
            d = [np.abs(codec.decode(buf, dev, to_rgb=False).cpu().numpy()
                        .astype(np.int64) - pix) for buf, pix in entries]
            res[name][case] = {"mean_abs_diff": float(np.mean(
                [x.mean() for x in d])), "max_abs_diff": int(max(
                    x.max() for x in d)), "images": len(d)}
        res[name]["hardware_status"] = codec.hardware_status()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
