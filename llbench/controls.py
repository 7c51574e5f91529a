"""python3 -m llbench.controls --workload CELL [--seeds N ...] [--control-seeds N ...]

The readings a cell's limits are set from, at the cell's own size, with
no measured window: each number that decides ``correct`` as sound runs
of the program give it, and as the control gives it (the reference put
in the program's place and computed in the precision below the
configuration's), and for a training cell as its faults give it.  One
JSON line a reading.  The benchmark's own runs do not run this.

* Codec cells: the program's container of every call of the pool
  against the reference's (every call any seed can sample), and every
  decoded image against its input; the control is the reference encoder
  under TF32 (the codec states float32 with TF32 off).
* Training cells: the checked steps from each seed's weights and batches
  against the reference's (in a cell of several cards on its cards, one
  process a rank, which this command starts, and the worst rank's
  numbers); the control is the reference under bfloat16
  autocast (the step states float32, with cuDNN's TF32 allowed); the
  fault "half of the batch left out, the mean taken over the rest" is
  the reference on the first half of each microbatch, and in a cell of
  several cards the fault "the exchange between cards left out" is the
  reference on rank 0's part, its rate over the global batch's
  subpixels, never summed over the ranks.  The fault "a step
  that returns its state unchanged" reads 1 on ``update_norm_gap`` by
  its definition, and needs no run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List

from . import checks, ranks, run
from .data import trained_weights
from .reference import codec as ref_codec
from .reference import model as ref_model
from .reference import train as ref_train


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def codec_readings(ctx, control_seeds: List[int]) -> None:
    import torch

    from llicti_torch import Codec

    from .data import synthetic_images
    from .traffic import permutation, port_config
    p, dev = ctx.params, ctx.device
    H, W, K = p["height"], p["width"], p["batch"]
    weights = trained_weights(ctx.config["weights"])
    pool = synthetic_images(p["pool"], H, W, p["pool_seed"], dev).cpu().numpy()
    units = [list(range(u * K, (u + 1) * K)) for u in range(p["pool"] // K)]
    codec = Codec(port_config(ctx.config), weights, device=dev,
                  num_lanes=p["lanes"])
    got = {}
    for u, idx in enumerate(units):
        imgs = [pool[i] for i in idx]
        if K == 1:
            streams = codec.compress(imgs[0])
            outs = [codec.decompress(streams)]
        else:
            streams = codec.compress_batch(imgs)
            outs = codec.decompress_batch(streams)
        got[u] = (ref_codec.serialize(streams),
                  sum(checks.wrong_subpixels(o, pool[i])
                      for o, i in zip(outs, idx)))
    del codec
    torch.cuda.empty_cache()
    model = ref_model.build(ref_model.Config(ctx.config["model"]),
                            ref_model.from_flax(weights), dev)
    exact = ref_codec.Encoder(model, p["lanes"], dev)
    tf32 = ref_codec.Encoder(model, p["lanes"], dev, tf32=True)

    def encode(enc, u):
        imgs = [pool[i] for i in units[u]]
        out = enc.encode_batch(imgs) if K > 1 else enc.encode(imgs)
        return ref_codec.serialize(out["streams"])

    for u in range(len(units)):
        want = encode(exact, u)
        emit(side="program", unit=u,
             container_bytes_off=checks.bytes_off(got[u][0], want),
             wrong_subpixels=got[u][1])
        got[u] = want
    for seed in control_seeds:
        u = permutation(len(units), seed, 1)[0]
        emit(side="control_tf32", seed=seed, unit=u,
             container_bytes_off=checks.bytes_off(encode(tf32, u), got[u]))


def train_readings(ctx, seeds: List[int], control_seeds: List[int]) -> None:
    import torch

    from .traffic import train_step
    t, p = ctx.config["train"], ctx.params

    def reference(c, state, batches, precision="float32", share=1.0):
        r = ref_train.run_steps(c, state, batches, t["learning_rate"],
                                t["grad_clip_value"], ctx.device, precision,
                                share)
        return {"losses": r["losses"], "grads": checks.norms(r["grads"]),
                "delta": checks.norms(r["delta"])}

    def numbers(side, seed, prog, ref):
        nums = checks.step_numbers(prog, ref)
        emit(side=side, seed=seed, **{k: v[0] for k, v in nums.items()},
             at={k: v[1] for k, v in nums.items()})

    for seed in seeds:  # the program on one card (cells of one card)
        c = dataclasses.replace(ctx, seed=seed)
        model, opt, step, rcfg, state, batches, hosts = train_step.setup(c)
        prog = train_step.program_readings(
            model, opt, lambda i: step(hosts[i % len(hosts)].to(
                ctx.device, non_blocking=True)), p["checked"])
        del model, opt, step, hosts
        torch.cuda.empty_cache()
        numbers("program", seed, prog,
                reference(rcfg, state, batches[:p["checked"]]))
    for seed in control_seeds:
        c = dataclasses.replace(ctx, seed=seed)
        _, _, _, rcfg, state, batches, _ = train_step.setup(c)
        ref = reference(rcfg, state, batches[:p["checked"]])
        numbers("control_bf16", seed,
                reference(rcfg, state, batches[:p["checked"]], "bf16"), ref)
        half = [b[:, :b.shape[1] // 2] for b in batches[:p["checked"]]]
        numbers("fault_half_batch", seed, reference(rcfg, state, half), ref)
        if ctx.world > 1:  # rank 0's part, its gradients never exchanged
            part = [b[:, :b.shape[1] // ctx.world]
                    for b in batches[:p["checked"]]]
            numbers("fault_no_exchange", seed,
                    reference(rcfg, state, part, share=1 / ctx.world), ref)


def dp_readings(ctx, seeds: List[int], control_seeds: List[int]) -> None:
    """The program on the cell's cards, every rank one process of this
    command in one process group: each seed's checked steps, compared
    on every rank with the reference, the worst rank's numbers emitted
    by rank 0; then rank 0 alone reads the control and the faults."""
    import torch.distributed as dist

    from .traffic import train_dp, train_step
    checked = ctx.params["checked"]
    for seed in seeds:
        c = dataclasses.replace(ctx, seed=seed)
        model, opt, step, call, rcfg, state, batches = train_dp.build(c)
        prog = train_step.program_readings(model, opt, call, checked)
        del model, opt, step, call
        nums, _ = train_dp.worst_numbers(c, prog, rcfg, state,
                                         batches[:checked])
        if ctx.rank == 0:
            emit(side="program", seed=seed, **{k: v[0] for k, v in
                                               nums.items()},
                 at={k: v[1] for k, v in nums.items()})
    dist.barrier()
    dist.destroy_process_group()
    if ctx.rank == 0 and control_seeds:
        train_readings(ctx, [], control_seeds)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m llbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    # a rank of a cell of several cards, started by rank 0
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    # the CPU in place of the cards, for the benchmark's own tests
    ap.add_argument("--device", choices=("cpu",), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    # the program of a cell of several cards runs on its cards, one rank
    # a card; the rest (the program of a one-card cell, the control and
    # the faults, which are the reference's) on one card
    dp = chips > 1 and bool(args.seeds)
    procs = []
    if dp and not args.rank:
        args.port = ranks.free_port()
        argv = ["--workload", args.workload, "--seeds"] + [
            str(s) for s in args.seeds]
        if args.device:
            argv += ["--device", args.device]
        procs = ranks.start("llbench.controls", argv, chips, args.port,
                            run.ROOT)
    ctx, _, _ = run.prepare(argparse.Namespace(
        workload=args.workload, seed=0, seconds=0.0, trace=0,
        rank=args.rank, port=args.port, spawn=False),
        device=args.device or (None if dp else "cuda"))
    try:
        if ctx.workload["generator"] in ("codec_roundtrip", "codec_batch"):
            codec_readings(ctx, args.control_seeds)
        elif dp:
            dp_readings(ctx, args.seeds, args.control_seeds)
        else:
            train_readings(ctx, args.seeds, args.control_seeds)
    finally:
        ranks.wait(procs)


if __name__ == "__main__":
    main(sys.argv[1:])
