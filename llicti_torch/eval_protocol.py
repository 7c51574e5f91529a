"""The reference's eval_model protocol over every holdout image, with
committable evidence: ``python -m llicti_torch.eval_protocol [OUT_DIR]``.

The port's counterpart of ``tools/eval_protocol.py``, with its splits
(``valid``, ``test``, ``test`` cropped to 512), its log lines, per-image
records and ``results.json`` summary keys.  Mirrors
agents/llicti_agent.py:122-164: per image, the real codec round trip
(actual bytes -> bpsp), the bit-exactness check, cold (first visit of a
shape) and warm encode / decode wall times, plus the estimate-vs-actual
cross-check (rate_dist.py:97-135), the coder closure against the ideal
bits of the coder's own tables, and the test-epoch scale x band x colour
rate table (loggers/rate.py:120-168).  The strict est/act comparison is
``max_abs_gap_pct_exact_mult`` over the ``n_exact_mult`` images whose size
is a multiple of the DWT footprint: only there do estimate and stream
code the same pixels.

The corpus (``data_corpus/{valid,test}``, not in the repository) is
``main``'s ``root``.  Weights: the trained flagship
(``llicti_torch/weights/bench_params.npz``) unless ``params`` is given.
Environment, as the JAX tool's: ``LLICTI_EVAL_SKIP`` / ``LLICTI_EVAL_ONLY``
(comma lists of file names to skip / to run alone), ``LLICTI_EVAL_APPEND=1``
(merge into an existing results.json, an image's earlier entry replaced),
``LLICTI_EVAL_BUCKET`` (files, or ``all``, coded through a
``size_bucket`` codec of ``LLICTI_EVAL_BUCKET_SIZE``, default 64);
``LLICTI_EVAL_PLATFORM`` is the device (default ``cuda``; the tool raises
without a card unless it is ``cpu``).  On the card the codec takes 1024
lanes and Kernel 1's tables, on the CPU 128 lanes and the float-CDF path,
as the JAX tool switches on its TPU.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np
import torch

from .codec import Codec
from .config import ModelConfig
from .data.dataset import list_images, load_rgb
from .training.trainer import pad_to_multiple
from .utils.logging_utils import RateLogger
from .weights import BENCH_PARAMS, load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def weights_meta() -> dict:
    """What the default weights are: their file, and the meta of the
    checkpoint they were exported from where the repository holds it."""
    meta = {"weights": os.path.relpath(BENCH_PARAMS, REPO)}
    path = os.path.join(REPO, "bench_ckpt", "bench.meta.json")
    if os.path.exists(path):
        with open(path) as f:
            meta.update(json.load(f))
    return meta


def main(out_dir: str, root: str = os.path.join(REPO, "data_corpus"),
         params=None) -> dict:
    """Run the protocol over ``root``'s splits into ``out_dir``; -> the
    summary written to ``out_dir/results.json``."""
    device = torch.device(os.environ.get("LLICTI_EVAL_PLATFORM", "cuda"))
    os.makedirs(out_dir, exist_ok=True)
    # LLICTI_EVAL_APPEND=1: merge into an existing results.json instead of
    # starting fresh (images that need a separate process)
    append = os.environ.get("LLICTI_EVAL_APPEND") == "1"
    log_path = os.path.join(out_dir, "eval_log.txt")
    logger = logging.getLogger("eval_protocol")
    logger.setLevel(logging.INFO)
    logger.handlers = [logging.FileHandler(log_path,
                                           mode="a" if append else "w"),
                       logging.StreamHandler()]
    for h in logger.handlers:
        h.setFormatter(logging.Formatter("%(message)s"))

    cfg = ModelConfig()
    meta = weights_meta() if params is None else {"weights": "given"}
    if params is None:
        params = load_npz()
    logger.info("checkpoint: %s", json.dumps(meta))
    on_card = device.type == "cuda"
    lanes = 1024 if on_card else 128
    codec = Codec(cfg, params, device=device, use_kernel_cdf=on_card,
                  num_lanes=lanes)
    device_name = (torch.cuda.get_device_name(device) if on_card
                   else str(device))

    def est_bits_of(c, x: np.ndarray) -> float:
        """Estimated bits of the padded image: the rate forward's
        self-information, summed."""
        with torch.inference_mode():
            maps = c.model(torch.from_numpy(x).to(device))
        return float(sum(m.sum(dtype=torch.float64) for m in maps))

    mult = 2 ** (max(cfg.dwtlevels) + 1)
    test_logger = RateLogger("eval-rate")
    test_logger.logger = logger

    results = []
    if append and os.path.exists(os.path.join(out_dir, "results.json")):
        with open(os.path.join(out_dir, "results.json")) as f:
            results.extend(json.load(f).get("per_image", []))

    skip = set(filter(None, os.environ.get(
        "LLICTI_EVAL_SKIP", "").split(",")))
    only = set(filter(None, os.environ.get(
        "LLICTI_EVAL_ONLY", "").split(",")))
    bucket_files = set(filter(None, os.environ.get(
        "LLICTI_EVAL_BUCKET", "").split(",")))
    bucket_size = int(os.environ.get("LLICTI_EVAL_BUCKET_SIZE", "64"))
    codec_bucketed = [None]  # lazy: most runs never touch it

    def flush():
        by = {}
        for r in results:
            if r.get("ok"):
                by.setdefault(r["split"], []).append(r["bpsp"])
        done = [r for r in results if "bpsp" in r]
        exact = [r for r in done
                 if r["h"] % mult == 0 and r["w"] % mult == 0]
        summary = {
            "checkpoint": meta,
            "devices": sorted({r.get("device", "?") for r in done}),
            "n_images": len(done),
            "all_lossless": all(r["ok"] for r in done) and bool(done),
            "max_abs_gap_pct": max((abs(r["est_gap_pct"]) for r in done),
                                   default=0.0),
            # the coder closure, on every image
            "max_abs_coder_gap_pct": max(
                (abs(r["coder_gap_pct"]) for r in done
                 if "coder_gap_pct" in r), default=0.0),
            # est vs actual on the same pixel set: only sizes that are
            # multiples of the DWT footprint (elsewhere the padded-model
            # estimate codes replicate-pad rows the codec never pays for)
            "max_abs_gap_pct_exact_mult": max(
                (abs(r["est_gap_pct"]) for r in exact), default=0.0),
            "n_exact_mult": len(exact),
            "mean_bpsp": round(float(np.mean(
                [r["bpsp"] for r in done])), 4) if done else None,
            "mean_bpsp_by_split": {k: round(float(np.mean(v)), 4)
                                   for k, v in by.items()},
            "per_image": results,
        }
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return summary

    def run_image(label, idx, f, img, use_bucket=False):
        if use_bucket:
            if codec_bucketed[0] is None:
                codec_bucketed[0] = Codec(
                    cfg, params, device=device, use_kernel_cdf=on_card,
                    num_lanes=lanes, size_bucket=bucket_size)
            # the estimate covers the padded region the bucketed codec codes
            c, pm = codec_bucketed[0], bucket_size
        else:
            c, pm = codec, mult
        t0 = time.time()
        streams = c.compress(img)
        enc_cold = time.time() - t0
        t0 = time.time()
        out = c.decompress(streams, xorg=img)
        dec_cold = time.time() - t0
        # warm re-run: the first visit to a shape pays cuDNN's and the
        # allocator's set-up; the reference's times are steady-state
        t0 = time.time()
        streams = c.compress(img)
        enc_t = time.time() - t0
        t0 = time.time()
        out = c.decompress(streams, xorg=img)
        dec_t = time.time() - t0
        nbytes = Codec.num_bytes(streams)
        bpsp = nbytes * 8 / img.size
        # est / act both count the replicate-padded region (the codec codes
        # it then crops), per ORIGINAL subpixel like the actual bpsp
        est_bits = est_bits_of(c, pad_to_multiple(
            img[None].astype(np.float32) / 255.0, pm))
        est_bpsp = est_bits / img.size
        act_bits = sum(sum(row) for row in c.last_slice_bits)
        gap = (act_bits - est_bits) / max(est_bits, 1) * 100
        ideal_bits = sum(sum(row) for row in c.last_ideal_bits)
        coder_gap = (act_bits - ideal_bits) / max(ideal_bits, 1) * 100
        ok = bool(np.array_equal(out[0], img))
        numel = img.size
        hdr_row = ([len(s) * 8 / numel * 3 for s in streams[0]]
                   + [0.0] * 9)[:9]
        slice_rows = [[b / numel * 3 for b in row]
                      for row in c.last_slice_bits]
        test_logger(np.asarray([hdr_row] + slice_rows))
        msg = (f"{label}:{idx:2d} {os.path.basename(f)[:28]:28s} "
               f"{img.shape[0]:4d}x{img.shape[1]:4d} "
               f"bpsp= {bpsp:.3f} (est {est_bpsp:.3f}, gap {gap:+.1f}%; "
               f"ideal {ideal_bits/img.size:.3f}, "
               f"coder {coder_gap:+.2f}%) "
               f"ycocg_err={c.last_ycocg_err} "
               f"Enc/Dec-Times:{enc_t:.3f}/{dec_t:.3f} "
               f"(cold {enc_cold:.1f}/{dec_cold:.1f}) "
               + (f"[bucketed {bucket_size}] " if use_bucket else ""))
        msg += ("(Check: Decoded img matches original)" if ok else
                "(Error: Decoded img does NOT match original!)")
        logger.info(msg)
        results.append(dict(split=label, file=os.path.basename(f),
                            h=img.shape[0], w=img.shape[1],
                            bpsp=round(bpsp, 4),
                            est_bpsp=round(est_bpsp, 4),
                            est_gap_pct=round(gap, 2),
                            ideal_bpsp=round(ideal_bits / img.size, 4),
                            coder_gap_pct=round(coder_gap, 3),
                            ycocg_err=c.last_ycocg_err,
                            device=device_name,
                            enc_t=round(enc_t, 3),
                            dec_t=round(dec_t, 3),
                            enc_t_cold=round(enc_cold, 3),
                            dec_t_cold=round(dec_cold, 3), ok=ok,
                            **({"bucketed": bucket_size}
                               if use_bucket else {})))

    def run_split(split: str, crop: int = 0, label: str = ""):
        label = label or split
        files = list_images([os.path.join(root, split)])
        for idx, f in enumerate(files):
            name = os.path.basename(f)
            if only and name not in only:
                continue
            # an append never duplicates an entry: drop this (split, file)'s
            # earlier one
            results[:] = [r for r in results
                          if not (r["split"] == label and r["file"] == name)]
            if name in skip:
                logger.info("%s:%2d %s SKIPPED (LLICTI_EVAL_SKIP)",
                            label, idx, name)
                results.append(dict(split=label, file=name, skipped=True))
                continue
            img = load_rgb(f)
            if crop:
                img = img[:crop, :crop]
            use_bucket = name in bucket_files or "all" in bucket_files
            try:
                run_image(label, idx, f, img, use_bucket)
            except Exception as e:  # noqa: BLE001 — recorded, run goes on
                logger.info("%s:%2d %s CRASHED: %s", label, idx, name,
                            repr(e)[:200])
                results.append(dict(split=label, file=name, crashed=True))
            flush()

    run_split("valid")
    run_split("test")
    # 512-crop variants of the test images (reference bench-size crops)
    run_split("test", crop=512, label="test_crop512")

    if test_logger.rates:  # a crashed/skipped-only run has no table rows
        test_logger.display(typ="te", epoch=0)
    summary = flush()
    logger.info("summary: %s", json.dumps(
        {k: v for k, v in summary.items() if k != "per_image"}))
    return summary


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.join(REPO, "docs", "eval_torch"))
