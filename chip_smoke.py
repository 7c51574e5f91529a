#!/usr/bin/env python3
"""Smoke run of the PyTorch port (llicti_torch) on one CUDA card.

Usage: python3 chip_smoke.py        (from the repository root, one GPU)

Phases, each of which raises on failure:
  1. print the card (nvidia-smi name and power limit); require CUDA;
  2. build the CUDA kernels from llicti_torch/csrc and print the build time;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (the finest band of a 512x768 image, 1024 lanes),
     and time both: Kernel 1 in its normal and logistic branches, Kernel 4
     (gmm_cdf_table_int32) on gmm_slice_params of the same parameter map,
     the rANS decode and encode;
  4. check the CUDA model against the CPU one on a small crop;
  5. the main path: Codec.compress -> serialize -> deserialize ->
     decompress of synthetic_image(512, 768, seed=42) with the trained
     flagship weights, byte-exact, with every kernel's launch count > 0;
  6. the same round trip on a 310x598 image (odd sizes, pad flags);
  7. Kernel 4's path (it lies on no codec path, in this package or the JAX
     one): tables of the finest band from gmm_slice_params, rANS-encoded
     at the true symbols and decoded back;
  8. the variants: one byte-exact round trip of the 512x768 image per
     coded configuration at flagship widths and depth (clrjnt 2 / 1 / 0 /
     0+seqmd x normal / logistic, GDN1, mwsa_joint, combine_layers1toL),
     plus 310x598 for clrjnt 1 and 0+seqmd; the trained weights for
     clrjnt 2 logistic, init_params(cfg, seed=0) for the rest (so only
     losslessness and the kernels mean anything there, not the bits).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from llicti_torch import (Codec, ModelConfig, _kernels, load_npz,
                          synthetic_image)
from llicti_torch import codec as cmod
from llicti_torch.coder import rans
from llicti_torch.ops import cdf
from llicti_torch.ops.color import rgb_int_to_ycocg_r_int
from llicti_torch.ops.gmm import cdf_sampling_points
from llicti_torch.ops.wavelet import lazy_dwt
from llicti_torch.weights import init_params

# (label, ModelConfig knobs, trained weights?, also 310x598?)
VARIANTS = [
    ("clrjnt2 normal", {}, False, False),
    ("clrjnt2 logistic", {"distribution": "logistic"}, True, False),
    ("clrjnt1 normal", {"clr_joint_mode": 1}, False, True),
    ("clrjnt1 logistic", {"clr_joint_mode": 1, "distribution": "logistic"},
     False, True),
    ("clrjnt0 normal", {"clr_joint_mode": 0}, False, False),
    ("clrjnt0 logistic", {"clr_joint_mode": 0, "distribution": "logistic"},
     False, False),
    ("clrjnt0+seqmd normal", {"clr_joint_mode": 0, "clrjnt0seqmd": True},
     False, True),
    ("clrjnt0+seqmd logistic", {"clr_joint_mode": 0, "clrjnt0seqmd": True,
                                "distribution": "logistic"}, False, True),
    ("clrjnt2 GDN1", {"activfun": "GDN1"}, False, False),
    ("clrjnt2 mwsa_joint", {"mwsa_joint": True}, False, False),
    ("clrjnt2 combine_layers1toL", {"combine_layers1toL": True}, False,
     False),
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, setup=None) -> float:
    """Mean milliseconds of fn(*setup(i)) over ``iters`` runs, by CUDA
    events around the whole loop (after one warm-up)."""
    args = [setup(i) if setup else () for i in range(iters + 1)]
    fn(*args[0])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(1, iters + 1):
        fn(*args[i])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| of two integer tensors of one shape (0 if empty)."""
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def kernel_phase(codec, img):
    """Kernels vs plain versions at the finest band of ``img``."""
    cfg, dev = codec.cfg, codec.device
    minmax, _ = cmod.host_header(img[None], cfg.dwtlevels)
    ranges = [cmod.clr_range(clr, minmax) for clr in range(3)]
    x = torch.from_numpy(img[None].copy()).to(dev)
    y_list, _, _ = lazy_dwt(codec._to_y(rgb_int_to_ycocg_r_int(x)),
                            cfg.dwtlevels, pad=True)
    y0 = y_list[0]
    h, w = y0.shape[1], y0.shape[2]
    with torch.inference_mode():
        pmap = codec.model.band_params(y0[..., :3].contiguous(), 0, 0)
    pm = pmap[0].reshape(h * w, -1).contiguous()
    y2 = y0[0].reshape(h * w, -1).contiguous()
    results = {}

    def compare_tables(label, cum, pcum):
        d = (cum.long() - pcum.long()).abs()
        mism = int((d > 0).sum())
        check(int(d.max()) <= 1, f"{label}: kernel differs by > 1 step")
        check(bool((cum[..., -1] == 65536).all()), "last entry != 2^16")
        check(bool((cum[..., 1:] > cum[..., :-1]).all()),
              "rows not increasing")
        return int(d.max()), mism, d.numel()

    def report(label, P, err, mism, size, ms, plain_ms):
        print(f"{label} n={h * w} P={P}: max|d|={err} "
              f"mismatches={mism}/{size} ({100.0 * mism / size:.5f}%), "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    def cdf_case(clr, minv, maxv, logistic=False):
        M, s0, m0, w0, upd = cmod.pmap_cdf_spec(cfg, 0, clr)
        sch = cmod.sym_channel(cfg, 0, clr)
        pts = cdf_sampling_points(minv, maxv).to(dev)
        args = (pts, pm, y2, M, s0, m0, w0, upd, logistic, sch, minv)
        cum, st, fr = cdf.gmm_cdf_from_pmap(*args)
        pcum, _, _ = cdf.gmm_cdf_from_pmap_plain(*args)
        torch.cuda.synchronize()
        P = cum.shape[1]
        label = f"kernel1{' logistic' if logistic else ''} clr={clr}"
        err, mism, size = compare_tables(label, cum, pcum)
        sym = (torch.round(y2[:, sch] * 255.0).int() - minv).clamp(0, P - 2)
        lo = cum.gather(1, sym.long()[:, None])[:, 0]
        hi = cum.gather(1, sym.long()[:, None] + 1)[:, 0]
        check(bool(torch.equal(st, lo) and torch.equal(fr, hi - lo)),
              "kernel (start, freq) != lookup into its own table")
        ms = cuda_ms(lambda: cdf.gmm_cdf_from_pmap(*args), 20)
        plain_ms = cuda_ms(lambda: cdf.gmm_cdf_from_pmap_plain(*args), 5)
        report(label, P, err, mism, size, ms, plain_ms)
        return cum, st, fr, err, ms, plain_ms

    def table_case(clr, minv, maxv):
        """Kernel 4 on gmm_slice_params of the same parameter map."""
        params = [t.contiguous() for t in
                  cmod.gmm_slice_params(cfg, pmap, y0, 0, clr)]
        pts = cdf_sampling_points(minv, maxv).to(dev)
        cum = cdf.gmm_cdf_table_int32(pts, *params)
        pcum = cdf.gmm_cdf_table_int32_plain(pts, *params)
        torch.cuda.synchronize()
        err, mism, size = compare_tables(f"kernel4 clr={clr}", cum, pcum)
        ms = cuda_ms(lambda: cdf.gmm_cdf_table_int32(pts, *params), 20)
        plain_ms = cuda_ms(
            lambda: cdf.gmm_cdf_table_int32_plain(pts, *params), 5)
        report(f"kernel4 clr={clr}", cum.shape[-1], err, mism, size, ms,
               plain_ms)
        return err, ms, plain_ms

    def summary(cases, widest):
        """(max |d| over every case, mean ms and plain ms over the image's
        three colour slices)"""
        return (max([c[-3] for c in cases] + widest),
                sum(c[-2] for c in cases) / 3, sum(c[-1] for c in cases) / 3)

    # Kernel 1 on the three slices of the band (the image's ranges), then
    # at the widest tables: Y at P=257 and Co at P=513; both branches
    sf, tables, k1 = [], [], []
    for clr in range(3):
        cum, st, fr, err, ms, plain_ms = cdf_case(clr, *ranges[clr])
        sf.append((st, fr))
        tables.append(cum)
        k1.append((err, ms, plain_ms))
    widest = [cdf_case(0, -127, 128)[3], cdf_case(1, -256, 255)[3]]
    results["cdf"] = summary(k1, widest)
    k1l = [cdf_case(clr, *ranges[clr], logistic=True)[3:]
           for clr in range(3)]
    widest = [cdf_case(0, -127, 128, True)[3], cdf_case(1, -256, 255, True)[3]]
    results["cdf_logistic"] = summary(k1l, widest)
    k4 = [table_case(clr, *ranges[clr]) for clr in range(3)]
    results["table"] = summary(k4, [table_case(0, -127, 128)[0],
                                    table_case(1, -256, 255)[0]])

    # Kernel 3: encode the three slices (reverse order), kernel vs plain
    N = codec.N
    cap = 3 * (h * w) + N

    def enc(fn):
        states = torch.full((N,), rans.RANS_L, dtype=torch.int64, device=dev)
        cursor = torch.zeros((1,), dtype=torch.int32, device=dev)
        buf = torch.zeros((cap,), dtype=torch.int32, device=dev)
        for st, fr in reversed(sf):
            fn(st, fr, states, cursor, buf)
        return states, cursor, buf

    ks, kc, kb = enc(rans.rans_encode)
    ps, pc, pb = enc(rans.rans_encode_plain)
    torch.cuda.synchronize()
    total = int(kc[0])
    check(int(pc[0]) == total, "rANS encode kernel != plain word count")
    enc_err = max(max_abs(ks, ps), max_abs(kb[:total], pb[:total]))
    check(enc_err == 0, "rANS encode kernel != plain version")
    blob = rans.pack_stream_packed(kb[:total].cpu().numpy(), ks.cpu().numpy())
    print(f"kernel3 encode: 3 slices x {h * w} symbols, N={N}: "
          f"{total} words, identical stream bytes and states")
    st0, fr0 = sf[0]

    def fresh_enc(_):
        return (torch.full((N,), rans.RANS_L, dtype=torch.int64, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev),
                torch.zeros((cap,), dtype=torch.int32, device=dev))

    results["encode"] = (
        enc_err, cuda_ms(lambda s, c, b: rans.rans_encode(st0, fr0, s, c, b), 20,
                   fresh_enc),
        cuda_ms(lambda s, c, b: rans.rans_encode_plain(st0, fr0, s, c, b), 3,
                fresh_enc))

    # Kernel 2: decode the blob, kernel vs plain; symbols must round-trip
    states_np, words_np = rans.unpack_stream(blob, N)
    words = torch.from_numpy(words_np).to(dev)

    def dec(fn):
        states = torch.from_numpy(states_np.astype(np.int64)).to(dev)
        offset = torch.zeros((1,), dtype=torch.int32, device=dev)
        syms = [fn(cum, words, states, offset) for cum in tables]
        return syms, states, offset

    ksy, kst, koff = dec(rans.rans_decode)
    psy, pst, poff = dec(rans.rans_decode_plain)
    torch.cuda.synchronize()
    dec_err = max([max_abs(a, b) for a, b in zip(ksy, psy)]
                  + [max_abs(kst, pst), max_abs(koff, poff)])
    check(dec_err == 0, "rANS decode kernel != plain version")
    for clr in range(3):
        true_sym = (torch.round(y2[:, cmod.sym_channel(cfg, 0, clr)] * 255.0)
                    .int() - ranges[clr][0])
        check(torch.equal(ksy[clr], true_sym), "decoded symbols != encoded")
    check(int(koff[0]) == total, "decoder read a different word count")
    print("kernel2 decode: identical symbols, states and offset; "
          "symbols round-trip")

    def fresh_dec(_):
        return (torch.from_numpy(states_np.astype(np.int64)).to(dev),
                torch.zeros((1,), dtype=torch.int32, device=dev))

    results["decode"] = (
        dec_err, cuda_ms(lambda s, o: rans.rans_decode(tables[0], words, s, o), 20,
                   fresh_dec),
        cuda_ms(lambda s, o: rans.rans_decode_plain(tables[0], words, s, o),
                3, fresh_dec))
    return results


def model_phase(codec, params, img):
    """The CUDA model and codec against the CPU ones on a small crop."""
    crop = np.ascontiguousarray(img[:64, :96])
    cpu = Codec(codec.cfg, params, device="cpu", num_lanes=codec.N)
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.uniform(-0.4, 0.4, (1, 32, 48, 12))
                         .astype(np.float32))
    with torch.inference_mode():
        for b in range(3):
            a = cpu.model.band_params(y[..., :3 * (b + 1)].contiguous(), 0, b)
            g = codec.model.band_params(
                y[..., :3 * (b + 1)].contiguous().to(codec.device), 0, b)
            err = float((a - g.cpu()).abs().max())
            print(f"model band {b}: CUDA vs CPU pmap max|d|={err:.3e}")
            check(torch.allclose(a, g.cpu(), rtol=1e-4, atol=1e-5),
                  "CUDA pmap differs from the CPU pmap")
    s_cpu, s_gpu = cpu.compress(crop), codec.compress(crop)
    check(s_cpu[0][0][:13] == s_gpu[0][0][:13]
          and s_cpu[0][1:4] == s_gpu[0][1:4], "headers differ")
    b_cpu, b_gpu = Codec.num_bytes(s_cpu), Codec.num_bytes(s_gpu)
    print(f"64x96 crop: CPU {b_cpu} bytes, CUDA {b_gpu} bytes")
    check(abs(b_cpu - b_gpu) <= max(0.001 * b_cpu, 16), "sizes differ")
    check(np.array_equal(codec.decompress(s_gpu)[0], crop), "crop lossy")


def round_trip(codec, img, label: str):
    """One timed compress -> serialize -> deserialize -> decompress."""
    H, W = img.shape[:2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = codec.compress(img)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blob = Codec.serialize(streams)
    back = Codec.deserialize(blob)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = codec.decompress(back, xorg=img)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(out.shape == (1, H, W, 3) and out.dtype == np.uint8,
          f"{label}: decoded shape {out.shape} {out.dtype}")
    check(np.array_equal(out[0], img), f"{label}: decoded image != input")
    check(codec.last_ycocg_err == 0, f"{label}: ycocg err "
          f"{codec.last_ycocg_err}")
    act = sum(sum(r) for r in codec.last_slice_bits)
    ideal = sum(sum(r) for r in codec.last_ideal_bits)
    gap = (act - ideal) / ideal * 100
    check(len(codec.last_slice_bits) == codec.cfg.num_scales
          and all(len(r) == 9 for r in codec.last_slice_bits),
          "slice bits table shape")
    check(abs(gap) <= 1.0, f"{label}: coder closure gap {gap:+.3f}% > 1%")
    nbytes = len(blob)
    bpsp = Codec.num_bytes(streams) * 8 / img.size
    print(f"{label}: lossless, {nbytes} bytes serialized, bpsp {bpsp:.4f}, "
          f"stream bits {act} vs ideal {ideal:.1f} ({gap:+.3f}%), "
          f"encode {1e3 * (t1 - t0):.2f} ms, decode {1e3 * (t3 - t2):.2f} "
          f"ms, peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB")


def table_path(codec, img):
    """Kernel 4's path: the finest band's three tables from
    gmm_slice_params (Kernel 4), rANS-encoded at the true symbols and
    decoded back to them."""
    cfg, dev, N = codec.cfg, codec.device, codec.N
    minmax, _ = cmod.host_header(img[None], cfg.dwtlevels)
    x = torch.from_numpy(img[None].copy()).to(dev)
    y0 = lazy_dwt(codec._to_y(rgb_int_to_ycocg_r_int(x)), cfg.dwtlevels,
                  pad=True)[0][0]
    with torch.inference_mode():
        pmap = codec.model.band_params(y0[..., :3].contiguous(), 0, 0)
    tables, syms, sf = [], [], []
    for clr in range(3):
        minv, maxv = cmod.clr_range(clr, minmax)
        pts = cdf_sampling_points(minv, maxv).to(dev)
        params = [t.contiguous() for t in
                  cmod.gmm_slice_params(cfg, pmap, y0, 0, clr)]
        cum = cdf.gmm_cdf_table_int32(pts, *params).reshape(-1, len(pts))
        sym = (torch.round(y0[..., cmod.sym_channel(cfg, 0, clr)] * 255.0)
               .int() - minv).reshape(-1, 1).long()
        lo = cum.gather(1, sym)[:, 0]
        sf.append((lo, cum.gather(1, sym + 1)[:, 0] - lo))
        tables.append(cum)
        syms.append(sym[:, 0].int())
    states = torch.full((N,), rans.RANS_L, dtype=torch.int64, device=dev)
    cursor = torch.zeros((1,), dtype=torch.int32, device=dev)
    buf = torch.zeros((3 * syms[0].numel() + N,), dtype=torch.int32,
                      device=dev)
    for st, fr in reversed(sf):
        rans.rans_encode(st, fr, states, cursor, buf)
    total = int(cursor[0])
    blob = rans.pack_stream_packed(buf[:total].cpu().numpy(),
                                   states.cpu().numpy())
    states_np, words_np = rans.unpack_stream(blob, N)
    states = torch.from_numpy(states_np.astype(np.int64)).to(dev)
    offset = torch.zeros((1,), dtype=torch.int32, device=dev)
    words = torch.from_numpy(words_np).to(dev)
    for cum, sym in zip(tables, syms):
        check(torch.equal(rans.rans_decode(cum, words, states, offset), sym),
              "Kernel 4 tables: decoded symbols != encoded")
    print(f"kernel4 path: 3 tables x {syms[0].numel()} pixels -> {total} "
          f"words -> decoded symbols identical")


def variants_phase(img, odd):
    """One round trip per coded configuration; returns the logistic
    branch's launches over the logistic configurations' counted runs."""
    t0 = time.perf_counter()
    trained = load_npz()
    logistic_launches = 0
    for label, kw, use_trained, also_odd in VARIANTS:
        cfg = ModelConfig(**kw)
        codec = Codec(cfg, trained if use_trained else init_params(cfg, 0),
                      device="cuda", num_lanes=1024)
        logistic = cfg.distribution == "logistic"
        for im in (img, odd) if also_odd else (img,):
            H, W = im.shape[:2]
            codec.decompress(codec.compress(im))  # warm-up
            k1 = cdf.gmm_cdf_from_pmap
            k1.launches = k1.logistic_launches = 0
            round_trip(codec, im, f"{label} {H}x{W}")
            check(k1.launches > 0, f"{label}: Kernel 1 was not launched")
            check(k1.logistic_launches == (k1.launches if logistic else 0),
                  f"{label}: Kernel 1 ran the wrong branch")
            logistic_launches += k1.logistic_launches
        del codec
        torch.cuda.empty_cache()
    print(f"variants phase: {len(VARIANTS)} configurations in "
          f"{time.perf_counter() - t0:.2f} s")
    return logistic_launches


def main() -> None:
    print(card_line())
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    t0 = time.perf_counter()
    _kernels.lib()
    print(f"kernels built (nvcc) and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    cfg = ModelConfig()
    params = load_npz()
    codec = Codec(cfg, params, device="cuda", num_lanes=1024)
    img = synthetic_image(512, 768, seed=42)
    kres = kernel_phase(codec, img)
    model_phase(codec, params, img)

    counters = (cdf.gmm_cdf_from_pmap, rans.rans_decode, rans.rans_encode)
    codec.decompress(codec.compress(img))  # warm-up
    for fn in counters:
        fn.launches = 0
    round_trip(codec, img, "512x768 flagship")
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"main path launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was not launched")
    odd = synthetic_image(310, 598, seed=7)
    codec.decompress(codec.compress(odd))  # warm-up
    before = {fn.__name__: fn.launches for fn in counters}
    round_trip(codec, odd, "310x598")
    check(all(fn.launches > before[fn.__name__] for fn in counters),
          "310x598 round trip skipped a kernel")

    cdf.gmm_cdf_table_int32.launches = 0
    table_path(codec, img)
    launches["gmm_cdf_table_int32"] = cdf.gmm_cdf_table_int32.launches
    check(launches["gmm_cdf_table_int32"] > 0, "Kernel 4 was not launched")
    launches["gmm_cdf_from_pmap_logistic"] = variants_phase(img, odd)
    check(launches["gmm_cdf_from_pmap_logistic"] > 0,
          "Kernel 1's logistic branch was not launched")
    check("jax" not in sys.modules, "jax was imported")

    rows = [
        ("gmm_cdf_from_pmap", "llicti_torch/csrc/cdf_pmap.cu",
         "llicti_tpu/ops/cdf_pallas.py:134", "cdf"),
        ("gmm_cdf_from_pmap_logistic", "llicti_torch/csrc/cdf_pmap.cu",
         "llicti_tpu/ops/cdf_pallas.py:134", "cdf_logistic"),
        ("gmm_cdf_table_int32", "llicti_torch/csrc/cdf_pmap.cu",
         "llicti_tpu/ops/cdf_pallas.py:192", "table"),
        ("rans_decode", "llicti_torch/csrc/rans.cu",
         "llicti_tpu/coder/rans_device.py:231", "decode"),
        ("rans_encode", "llicti_torch/csrc/rans.cu",
         "llicti_tpu/coder/rans_device.py:142", "encode"),
    ]
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": kres[key][0], "ms": kres[key][1],
                "plain_ms": kres[key][2]} for name, src, rep, key in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
