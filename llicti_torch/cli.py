"""File-level codec CLI: encode an image to a .llic bitstream and back.

Usage:
  python -m llicti_torch.cli encode IMAGE OUT.llic [--ckpt PATH] [--config J]
  python -m llicti_torch.cli decode IN.llic OUT.png [--ckpt PATH] [--config J]
  (or the ``llicti-torch`` script)

The port's counterpart of ``llicti_tpu/cli.py``, with its options and its
stderr lines.  The bitstream is the serialized stream-group list
(``Codec.serialize``).  The weights come from ``--ckpt``: a port
checkpoint directory (``{--ckpt-name}.pt``, as the Trainer writes it) or an
``.npz`` of Flax-named arrays (``llicti_torch/weights/bench_params.npz``);
without it, random weights from ``init_params(cfg, 0)`` (still lossless,
just a poor rate; JAX's draws its own with ``PRNGKey(0)``).  IMAGE is a
PNG / JPEG (through PIL) or, unlike the JAX CLI, a uint8 H×W×3 ``.npy``.
The decoder writes OUT through PIL, or ``OUT.npy`` where PIL is missing.
The codec runs on the CUDA card unless ``--device cpu`` is given, and codes
with Kernel 1's tables, where the JAX CLI keeps ``use_pallas_cdf=False``;
``--lanes`` (default 512, as JAX's) must match between encode and decode.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .codec import Codec
from .config import ModelConfig, config_from_json
from .data.dataset import load_rgb
from .utils.checkpoint import CheckpointManager
from .weights import flax_from_state_dict, init_params, load_npz


def load_params(ckpt, name: str, cfg: ModelConfig):
    """Flax-named weights of ``cfg`` from an ``.npz``, a port checkpoint
    directory's ``{name}.pt``, or (``ckpt`` None) ``init_params(cfg, 0)``."""
    if ckpt is None:
        return init_params(cfg, 0)
    if ckpt.endswith(".npz"):
        return load_npz(ckpt)
    if not os.path.isdir(ckpt):
        raise FileNotFoundError(f"checkpoint directory not found: {ckpt}")
    state, _ = CheckpointManager(ckpt).load(name)
    return flax_from_state_dict(state["model"], cfg)


def load_codec(args) -> Codec:
    cfg = (config_from_json(args.config).model if args.config
           else ModelConfig())
    return Codec(cfg, load_params(args.ckpt, args.ckpt_name, cfg),
                 device=args.device, num_lanes=args.lanes)


def save_rgb(path: str, img: np.ndarray) -> str:
    """Write uint8 [H, W, 3] through PIL, or to ``path + ".npy"`` where PIL
    is missing; -> the file written."""
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", img)
        return path + ".npy"
    Image.fromarray(img).save(path)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llicti_torch.cli")
    ap.add_argument("cmd", choices=["encode", "decode"])
    ap.add_argument("inp")
    ap.add_argument("out")
    ap.add_argument("--ckpt", default=None,
                    help="port checkpoint dir or Flax-named .npz")
    ap.add_argument("--ckpt-name", default="bench")
    ap.add_argument("--config", default=None, help="JSON config path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=512)
    args = ap.parse_args(argv)

    codec = load_codec(args)
    if args.cmd == "encode":
        img = load_rgb(args.inp)
        t0 = time.time()
        blob = Codec.serialize(codec.compress(img))
        with open(args.out, "wb") as f:
            f.write(blob)
        bpsp = len(blob) * 8 / img.size
        print(f"{args.inp}: {img.shape[0]}x{img.shape[1]} -> "
              f"{len(blob)} bytes ({bpsp:.3f} bpsp) "
              f"in {time.time()-t0:.2f}s", file=sys.stderr)
    else:
        with open(args.inp, "rb") as f:
            blob = f.read()
        t0 = time.time()
        out = codec.decompress(Codec.deserialize(blob))
        written = save_rgb(args.out, out[0])
        print(f"{args.inp}: -> {out.shape[1]}x{out.shape[2]} "
              f"written to {written} in {time.time()-t0:.2f}s",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
