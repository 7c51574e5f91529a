"""Experiment runtime: the agent equivalent (train/validate/test loops).

Port of ``llicti_tpu/training/trainer.py``.  Mirrors the reference
lifecycle (agents/base.py:13-150, agents/llicti_agent.py:14-207):
* epoch loop with mid-epoch validation + best-checkpoint every
  loss_prnt_iters optimizer steps,
* ReduceLROnPlateau stepped on validation loss,
* checkpoint-on-exception and checkpoint-on-finalize,
* eval_model: the real codec round trip with a bit-exactness check, bpsp
  from the actual bytes, the estimate and coder cross-checks, per-image
  enc/dec times and ``results.json``,
* model_size estimation from the parameters, flops estimation by
  ``torch.utils.flop_counter``.

The trainer runs on the CUDA card unless it is given ``device="cpu"``.
It sets no process-wide cuDNN or TF32 flag: the training step runs its
forward and backward with cuDNN's TF32 off and restores the caller's
value (``steps.fp32_convs``), the codec of ``eval_model`` scopes its own
(``codec.exact_math``), and the validation forward runs under the
caller's.  The step builders put the model in channels-last
(``steps.to_channels_last``), and so does a checkpoint's load, for the
Adam state it brings.  Host batches are uploaded pinned and
``non_blocking``.  With a mesh (``mesh=``, ``use_mesh=True``, or a
config's ``num_data_shards > 1``; one process a card under ``torchrun``)
the steps are data parallel: every rank's loader builds the same global
batch from the same seed and takes its part, the gradients are summed
over the ranks (``parallel/train.py``), validation losses are rank 0's,
``eval_model`` codes with the row-sharded codec, and rank 0 alone writes
logs, checkpoints and ``results.json``.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..codec import Codec
from ..config import LLICTIConfig
from ..data.dataset import EvalLoader, ImageDataset, TrainLoader
from ..parallel.codec_sp import ShardedCodec, make_sp_mesh
from ..parallel.distributed import broadcast_float, world_size
from ..parallel.mesh import batch_sharding, make_mesh
from ..parallel.train import make_parallel_train_step, shard_state
from ..utils.checkpoint import CheckpointManager
from ..utils.logging_utils import RateLogger, setup_logging
from ..utils.notify import Notifier
from ..weights import flax_from_state_dict, init_params, params_from_flax
from .schedule import ReduceLROnPlateau
from .steps import (get_learning_rate, make_eval_step, make_optimizer,
                    make_train_step, set_learning_rate, to_channels_last)


def pad_to_multiple(x: np.ndarray, mult: int) -> np.ndarray:
    """Replicate-pad H, W (axis 1, 2) up to a multiple (reference
    agents/llicti_agent.py:105-113)."""
    h, w = x.shape[1], x.shape[2]
    nh = -(-h // mult) * mult
    nw = -(-w // mult) * mult
    if nh == h and nw == w:
        return x
    return np.pad(x, ((0, 0), (0, nh - h), (0, nw - w), (0, 0)), mode="edge")


class Trainer:
    def __init__(self, config: LLICTIConfig, device="cuda", mesh=None,
                 use_mesh: bool = False):
        self.config = config
        cfg = config.model
        tc = config.train
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer runs on the CUDA card by default and none is "
                "available; pass device='cpu' to train on the CPU")
        # num_data_shards > 1 asks for data parallelism over that many
        # ranks even when the caller passed no mesh (no silent knobs)
        if mesh is None and not use_mesh and tc.num_data_shards > 1:
            use_mesh = True
        if mesh is None and use_mesh:
            data = tc.num_data_shards if tc.num_data_shards > 1 else None
            if data is not None and world_size() != data:
                raise RuntimeError(
                    f"num_data_shards={data} needs a process group of "
                    f"{data} ranks, found {world_size()}: start one process "
                    f"a card with torchrun --nproc_per_node={data} and "
                    "call llicti_torch.parallel.initialize()")
            mesh = make_mesh(data=data)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        if self.is_main:  # rank 0 alone writes the logs
            setup_logging(config.log_dir)
        self.logger = logging.getLogger("Agent")

        # datasets
        dc = config.data
        if dc.synthetic or not dc.train_dirs:
            train_ds = ImageDataset(synthetic_len=dc.synthetic_len,
                                    synthetic_size=max(tc.patch_size, 64),
                                    seed=tc.seed)
            valid_ds = ImageDataset(synthetic_len=max(4, dc.synthetic_len // 32),
                                    synthetic_size=max(tc.patch_size, 64),
                                    seed=tc.seed + 1)
            test_ds = valid_ds
        else:
            train_ds = ImageDataset(dc.train_dirs)
            valid_ds = ImageDataset([dc.valid_dir])
            test_ds = ImageDataset([dc.test_dir])
        self.train_loader = TrainLoader(
            train_ds, tc.batch_size, tc.patch_size, tc.grad_acc_iters,
            tc.patches_per_img, seed=tc.seed,
            num_threads=max(1, dc.dl_numworkers))
        self.valid_loader = EvalLoader(valid_ds, tc.val_patch_size,
                                       batch_size=tc.val_batch_size)
        self.test_loader = EvalLoader(test_ds, 0)

        # state
        self.model = params_from_flax(init_params(cfg, seed=tc.seed),
                                      cfg).to(self.device).train()
        self.optimizer = make_optimizer(self.model, tc.learning_rate)
        if mesh is not None:
            shard_state(self.model, self.optimizer, mesh)
            self.train_step = make_parallel_train_step(
                self.model, self.optimizer, mesh, tc.grad_clip_value)
            self.batch_cut = batch_sharding(mesh, has_acc_axis=True)
        else:
            self.train_step = make_train_step(self.model, self.optimizer,
                                              tc.grad_clip_value)
            self.batch_cut = None
        self.eval_step = make_eval_step(self.model)

        self.scheduler = ReduceLROnPlateau(
            lr=tc.learning_rate, factor=tc.lr_factor, patience=tc.lr_patience,
            cooldown=tc.lr_cooldown, min_lr=tc.lr_min,
            threshold=tc.lr_threshold)
        self.train_logger = RateLogger()
        self.trnit_logger = RateLogger()
        self.valid_logger = RateLogger()
        self.test_logger = RateLogger()
        # failure/completion notifications land in the experiment's event
        # log (SMTP transport available via Notifier fields)
        self.notifier = Notifier(event_log=os.path.join(
            config.log_dir, "events.jsonl") if self.is_main else "")
        self.ckpt = CheckpointManager(config.checkpoint_dir)
        self.current_epoch = 0
        self.current_iteration = 0
        self.best_valid_loss = float("inf")

        if config.mode in ("test", "validate", "eval_model", "debug"):
            self.load_checkpoint("model_best", missing_ok=True)
        elif tc.resume_training:
            self.load_checkpoint(tc.checkpoint_file, missing_ok=True)
        self.model_size_estimation()

    def upload(self, batch: np.ndarray) -> torch.Tensor:
        """A host float32 batch -> a tensor on the trainer's device."""
        t = torch.from_numpy(batch)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # --- checkpointing -----------------------------------------------------
    def save_checkpoint(self, name: str = "checkpoint",
                        is_best: bool = False) -> None:
        if not self.is_main:  # rank 0 alone writes checkpoints
            return
        meta = {
            "epoch": self.current_epoch,
            "iteration": self.current_iteration,
            "best_valid_loss": self.best_valid_loss,
            "scheduler": self.scheduler.state_dict(),
            "train_logger": self.train_logger.state_dict(),
            "trnit_logger": self.trnit_logger.state_dict(),
            "valid_logger": self.valid_logger.state_dict(),
        }
        # one optimiser step per iteration: the step count is the
        # iteration, as the JAX package's TrainState.step
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "step": self.current_iteration}
        self.ckpt.save(name, state, meta, is_best=is_best)

    def load_checkpoint(self, name: str, missing_ok: bool = False) -> bool:
        try:
            state, meta = self.ckpt.load(name)
        except FileNotFoundError:
            if missing_ok:
                self.logger.info(
                    "!!! No checkpoint '%s'; continuing with fresh params",
                    name)
                return False
            raise
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        to_channels_last(self.model, self.optimizer)
        self.current_epoch = meta.get("epoch", 0)
        self.current_iteration = meta.get("iteration", 0)
        self.best_valid_loss = meta.get("best_valid_loss", float("inf"))
        if "scheduler" in meta:
            self.scheduler.load_state_dict(meta["scheduler"])
            set_learning_rate(self.optimizer, self.scheduler.lr)
        for key, lg in (("train_logger", self.train_logger),
                        ("trnit_logger", self.trnit_logger),
                        ("valid_logger", self.valid_logger)):
            if key in meta:
                lg.load_state_dict(meta[key])
        self.logger.info("Checkpoint '%s' loaded (epoch %d, iter %d)",
                         name, self.current_epoch, self.current_iteration)
        return True

    # --- loops -------------------------------------------------------------
    def run(self) -> None:
        mode = self.config.mode
        try:
            if mode == "debug":
                # anomaly detection (reference agents/base.py:112-114): a
                # backward that makes a NaN fails with a traceback into the
                # forward op that produced it; scoped to this run
                with torch.autograd.set_detect_anomaly(True):
                    self.train()
            elif mode == "train":
                self.train()
            elif mode == "validate":
                self.validate()
            elif mode == "test":
                self.test()
            elif mode == "eval_model":
                self.eval_model()
            elif mode == "model_size":
                self.model_size_estimation(print_params=True)
            elif mode == "flops_est":
                self.flops_estimation()
            else:
                raise NameError(f"'{mode}' is not a valid mode")
        except KeyboardInterrupt:
            self.logger.info("CTRL+C received; finalizing")
        except Exception as exc:
            # crash-safety save (reference base.py:128-130) — but only if this
            # run actually made progress, so a mode typo can't clobber a good
            # checkpoint with fresh params
            if self.current_iteration > 0:
                self.save_checkpoint()
            self.notifier.send(
                f"[llicti] {self.config.exp_name} crashed in mode "
                f"'{mode}'",
                f"{type(exc).__name__}: {exc} "
                f"(epoch {self.current_epoch}, "
                f"iter {self.current_iteration})")
            raise

    def finalize(self) -> None:
        if self.config.mode in ("train", "debug") and self.current_iteration > 0:
            self.save_checkpoint()

    def train(self, max_steps: Optional[int] = None) -> None:
        tc = self.config.train
        for epoch in range(self.current_epoch, tc.max_epoch):
            self.current_epoch = epoch
            self.train_one_epoch(max_steps=max_steps)
            if (self.current_epoch + 1) % tc.validate_every == 0:
                valid_loss = self.validate()
                is_best = valid_loss < self.best_valid_loss
                if is_best:
                    self.best_valid_loss = valid_loss
                self.save_checkpoint(is_best=is_best)
            self.current_epoch += 1
            if max_steps is not None and self.current_iteration >= max_steps:
                break

    def train_one_epoch(self, max_steps: Optional[int] = None) -> None:
        tc = self.config.train
        for batch in self.train_loader:
            if self.batch_cut is not None:
                batch = np.ascontiguousarray(self.batch_cut(batch))
            metrics = self.train_step(self.upload(batch))
            bd = metrics["breakdown"].cpu().numpy()
            self.train_logger(bd)
            self.trnit_logger(bd)
            self.current_iteration += 1
            if (self.current_iteration + 1) % tc.loss_prnt_iters == 0:
                self.trnit_logger.display(
                    lr=get_learning_rate(self.optimizer), typ="it",
                    epoch=self.current_iteration)
                valid_loss = self.validate()
                is_best = valid_loss < self.best_valid_loss
                if is_best:
                    self.best_valid_loss = valid_loss
                self.save_checkpoint(is_best=is_best)
            if max_steps is not None and self.current_iteration >= max_steps:
                break
        if self.train_logger.rates:
            self.train_logger.display(lr=get_learning_rate(self.optimizer),
                                      typ="tr", epoch=self.current_epoch)

    def validate(self) -> float:
        mult = 2 ** (max(self.config.model.dwtlevels) + 1)
        for batch in self.valid_loader:
            batch = pad_to_multiple(batch, mult)
            _, bd = self.eval_step(self.upload(batch))
            self.valid_logger(bd.cpu().numpy())
        loss, _ = self.valid_logger.display(typ="va",
                                            epoch=self.current_epoch)
        if self.mesh is not None:  # one schedule on every rank
            loss = broadcast_float(loss)
        new_lr = self.scheduler.step(loss)
        if abs(new_lr - get_learning_rate(self.optimizer)) > 1e-12:
            set_learning_rate(self.optimizer, new_lr)
        return loss

    def test(self) -> float:
        """Estimate-only eval over the test set: differentiable rate per
        image, no entropy coding (the reference's test() is an empty stub,
        agents/llicti_agent.py:116-120)."""
        mult = 2 ** (max(self.config.model.dwtlevels) + 1)
        losses = []
        for batch in self.test_loader:
            batch = pad_to_multiple(batch, mult)
            total, _ = self.eval_step(self.upload(batch))
            losses.append(float(total))
        loss = float(np.mean(losses)) if losses else float("nan")
        self.logger.info("Test (estimate-only): mean rate %.4f bpp over "
                         "%d images", loss, len(losses))
        return loss

    def eval_model(self):
        """Real codec round trip over the test set (reference
        llicti_agent.py:122-164), with 512 rANS lanes on the card and 64 on
        the CPU, as the JAX package's uses 512 on its accelerator.  Per
        image: bpsp from the bytes, the estimate from the eval step on the
        replicate-padded image and its gap to the coded bits, the coder gap
        against the ideal bits of the coder's own tables, the lossless
        check and the encode / decode wall times; the rate table of the
        test set, and ``results.json`` in ``out_dir`` with the JAX
        package's keys.  The codec takes Kernel 1's tables (the JAX
        trainer's codec keeps ``use_pallas_cdf=False``).  With a mesh of
        more than one rank, a configuration the sharded codec codes goes
        through the row-sharded codec (one shard a rank, lanes // G lanes
        a shard, at least 32), as the JAX trainer's does; every rank codes
        and rank 0 writes ``results.json``."""
        cfg = self.config.model
        lanes = 512 if self.device.type == "cuda" else 64
        params = flax_from_state_dict(self.model.state_dict(), cfg)
        if (self.mesh is not None and self.mesh.size > 1
                and ShardedCodec.supports(cfg)):
            sp = make_sp_mesh()
            codec = ShardedCodec(cfg, params, mesh=sp, device=self.device,
                                 num_lanes=max(32, lanes // sp.G))
        else:
            codec = Codec(cfg, params, device=self.device, num_lanes=lanes)
        mult = 2 ** (max(cfg.dwtlevels) + 1)
        results = []
        for idx, img in enumerate(self.test_loader.iter_uint8()):
            t0 = time.time()
            streams = codec.compress(img)
            enc_t = time.time() - t0
            t0 = time.time()
            out = codec.decompress(streams)
            dec_t = time.time() - t0
            nbytes = Codec.num_bytes(streams)
            bpsp = nbytes * 8 / img.size
            # estimate-vs-actual cross-check (reference's third
            # verification leg, rate_dist.py:97-135): the differentiable
            # rate must track the real coded bits
            xpad = pad_to_multiple(
                img[None].astype(np.float32) / 255.0, mult)
            est_total, _ = self.eval_step(self.upload(xpad))
            est_bits = float(est_total) * xpad.size / 3
            est_bpsp = est_bits / img.size
            act_bits = sum(sum(row) for row in codec.last_slice_bits)
            gap_pct = (act_bits - est_bits) / max(est_bits, 1) * 100
            # second leg: the stream against the exact code length of the
            # coder's quantised, range-restricted tables
            ideal_bits = sum(sum(row) for row in codec.last_ideal_bits)
            coder_gap_pct = ((act_bits - ideal_bits) / max(ideal_bits, 1)
                             * 100 if ideal_bits else None)
            ok = bool(np.array_equal(out[0], img))
            numel = img.size
            hdr_row = ([len(s) * 8 / numel * 3 for s in streams[0]]
                       + [0.0] * 9)[:9]
            slice_rows = [[b / numel * 3 for b in row]
                          for row in codec.last_slice_bits]
            self.test_logger(np.asarray([hdr_row] + slice_rows))
            msg = (f"{idx:3d} {img.shape[0]:3d}x{img.shape[1]:3d} "
                   f"bpsp= {bpsp:.3f} (est {est_bpsp:.3f}, "
                   f"gap {gap_pct:+.1f}%")
            if coder_gap_pct is not None:
                msg += f", coder {coder_gap_pct:+.2f}%"
            msg += f") Enc/Dec-Times:{enc_t:.3f}/{dec_t:.3f} "
            if ok:
                msg += "(Check: Decoded img matches original)"
            else:
                err = np.abs(out[0].astype(int) - img.astype(int)).max()
                msg += (f"(Error: Decoded img does NOT match original! "
                        f"max abs err {err})")
            self.logger.info(msg)
            results.append(dict(bpsp=bpsp, est_bpsp=est_bpsp,
                                est_gap_pct=gap_pct,
                                coder_gap_pct=coder_gap_pct,
                                enc_t=enc_t, dec_t=dec_t, ok=ok))
        self.test_logger.display(typ="te")
        # results.json for tools/results_parser.py (reference
        # experiments/results_parser.py expects rate/dist per exp dir)
        if results and self.is_main:
            os.makedirs(self.config.out_dir, exist_ok=True)
            summary = {
                "rate": float(np.mean([r["bpsp"] for r in results])),
                "est_rate": float(np.mean([r["est_bpsp"] for r in results])),
                "dist": 0.0,
                "lossless": bool(all(r["ok"] for r in results)),
                "per_image": results,
            }
            with open(os.path.join(self.config.out_dir,
                                   "results.json"), "w") as f:
                json.dump(summary, f, indent=1)
        return results

    # --- introspection -----------------------------------------------------
    def model_size_estimation(self, print_params: bool = False) -> float:
        total = 0
        for name, p in self.model.named_parameters():
            if print_params:
                self.logger.info("%s %s", name, tuple(p.shape))
            total += p.numel() * p.element_size()
        mb = total / 1024 ** 2
        self.logger.info(
            "------------------TOT----------------------------------------")
        self.logger.info(
            " model param+buffer=total size: %.3f+0.000=%.3fMB", mb, mb)
        self.logger.info(
            "------------------END----------------------------------------")
        return mb

    def flops_estimation(self, h: int = 512, w: int = 512) -> float:
        """Float operations of one forward at 3 x h x w (the reference uses
        ptflops at 3x512x512, llicti_agent.py:194-200), counted by
        ``torch.utils.flop_counter.FlopCounterMode``; logs GMac (flops / 2)
        and the parameter count.  FlopCounterMode counts the convs alone,
        where the JAX package's XLA cost analysis also counts elementwise
        operations: on the flagship with random weights (CPU) the port
        counts 527,180,544 / 2,108,722,176 flops at 64² / 128² against
        JAX's 545,496,704 / 2,181,985,792, 3.4 % fewer."""
        x = torch.zeros((1, h, w, 3), device=self.device)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            self.model(x)
        flops = counter.get_total_flops()
        self.logger.info("Computational complexity: %.2f GMac",
                         flops / 2 / 1e9)
        n = sum(p.numel() for p in self.model.parameters())
        self.logger.info("Number of parameters: %.2f k", n / 1e3)
        return flops
