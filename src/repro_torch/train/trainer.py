"""Training loop of the port, with restart-resume fault tolerance
(``repro.train.trainer`` in torch, the same semantics):

  * checkpoint/restore with atomic manifests: ``Trainer.run`` begins by
    probing for the latest committed step and resumes from it (the data
    cursor rides in the manifest), so a killed job restarts exactly.  The
    saved tree is ``{"params": ..., "opt": (step, m, v)}`` in the
    reference's stacked layout (``models/convert.py``), so a directory
    either package's trainer writes resumes in the other;
  * a per-step straggler warning, and one retry on a transient step
    failure (``FloatingPointError`` from the NaN probe, or a
    ``RuntimeError``).  The retry steps from the params the failed step
    left, as the reference's reassignment does, and relaunches the same
    kernels: nothing falls back to another implementation;
  * gradient accumulation over micro-batches (the mean of per-micro
    gradients), for global batches above per-step memory;
  * optional int8 gradient compression ahead of the update, with one
    scale per reference leaf (all layers of a weight share it, as they
    share one stacked tensor in the reference).

Params live on ``device`` (None means CUDA) as an ``LM`` whose parameters
the trainer sets to require grads; the optimizer updates them in place.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.data.pipeline import DataState, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (
    stacked_groups,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.optim import AdamWState, linear_warmup_cosine, make_optimizer
from repro_torch.optim.grad_utils import compress_int8, decompress_int8


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    micro_batches: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    factored_optimizer: bool = False
    grad_compression: bool = False     # int8 gradient compression
    log_every: int = 10
    step_timeout_s: float = 600.0      # straggler watchdog
    max_step_retries: int = 1


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, *,
                 global_batch: int, seq_len: int, seed: int = 0,
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.dtype = dtype
        self.device = resolve_device(device)
        self.dataset = SyntheticLMDataset(cfg.vocab, seq_len, global_batch,
                                          seed)
        lr_fn = linear_warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.steps)
        self.opt_init, self.opt_update = make_optimizer(
            lr_fn=lr_fn, factored=tcfg.factored_optimizer,
            weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm,
        )
        self.ckpt = (
            CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
            if tcfg.checkpoint_dir
            else None
        )

    # -- one step --------------------------------------------------------------

    def _grads(self, lm: M.LM, named: dict, batch: dict):
        loss, _ = M.loss_fn(lm, self.cfg, batch)
        # a param no maths read (RWKV's mu_x) gets zeros, as under jax.grad
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), dict(zip(named, grads))

    def _step(self, lm: M.LM, named: dict, opt_state: AdamWState,
              batch: dict):
        mb = self.tcfg.micro_batches
        if mb > 1:
            b = batch["tokens"].shape[0] // mb
            g_sum, loss_sum = None, 0.0
            for i in range(mb):
                micro = {k: x[i * b:(i + 1) * b] for k, x in batch.items()}
                loss, g = self._grads(lm, named, micro)
                g_sum = g if g_sum is None else {k: g_sum[k] + g[k]
                                                 for k in g_sum}
                loss_sum = loss_sum + loss
            grads = {k: g / mb for k, g in g_sum.items()}
            loss = loss_sum / mb
        else:
            loss, grads = self._grads(lm, named, batch)
        if self.tcfg.grad_compression:
            # one scale per reference leaf: the layers of a stacked tensor
            q, s = compress_int8(grads, stacked_groups(grads))
            grads = decompress_int8(q, s, grads)
        _, opt_state, opt_metrics = self.opt_update(named, grads, opt_state)
        return opt_state, {"loss": loss, **opt_metrics}

    # -- checkpoints -----------------------------------------------------------

    def _tree(self, named: dict, opt_state: AdamWState) -> dict:
        """The saved tree, in the reference's layout with numpy leaves."""
        return {"params": state_to_numpy(self.cfg, named),
                "opt": (opt_state.step.cpu().numpy(),
                        state_to_numpy(self.cfg, opt_state.m),
                        state_to_numpy(self.cfg, opt_state.v))}

    def _save(self, step: int, named, opt_state, data_state: DataState):
        self.ckpt.save(step, self._tree(named, opt_state), extra={
            "data_state": data_state.to_dict(), "trainer_step": step})

    @torch.no_grad()
    def _restore(self, named: dict, opt_state: AdamWState):
        """Load the latest commit into ``named`` and ``opt_state`` in place;
        returns (data_state, step), or None when nothing is committed."""
        if latest_step(self.ckpt.directory) is None:
            return None
        found, tree, extra = self.ckpt.restore_latest(
            self._tree(named, opt_state))
        if found is None:
            return None
        step, m, v = tree["opt"]
        for dst, src in ((named, tree["params"]), (opt_state.m, m),
                         (opt_state.v, v)):
            for name, t in state_from_numpy(self.cfg, src, "cpu").items():
                for d, s in (zip(dst[name], t) if isinstance(t, tuple)
                             else ((dst[name], t),)):
                    d.copy_(s)
        opt_state.step.copy_(torch.as_tensor(step))
        return DataState.from_dict(extra["data_state"]), extra["trainer_step"]

    # -- fault-tolerant run ----------------------------------------------------

    def run(
        self,
        *,
        params: Optional[M.LM] = None,
        generator: Optional[torch.Generator] = None,
        on_metrics: Optional[Callable[[int, dict], None]] = None,
    ):
        """Train to ``tcfg.steps``, resuming from the latest checkpoint.
        ``params``: an ``LM`` on the trainer's device (trained in place), or
        None for ``init_params`` drawn from ``generator`` (seed 0 when
        None).  Returns (params, opt_state, history)."""
        if params is None:
            params = M.init_params(self.cfg, generator, self.device,
                                   self.dtype)
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        opt_state = self.opt_init(named)
        data_state = DataState(seed=self.dataset.seed, step=0)
        start_step = 0

        if self.ckpt is not None:
            resumed = self._restore(named, opt_state)
            if resumed is not None:
                data_state, start_step = resumed
                print(f"[trainer] resumed from step {start_step}")

        history = []
        step = start_step
        while step < self.tcfg.steps:
            batch = {k: torch.as_tensor(x, device=self.device)
                     for k, x in self.dataset.batch_at(data_state.step).items()}
            t0 = time.perf_counter()
            attempt = 0
            while True:
                try:
                    opt_state, metrics = self._step(params, named, opt_state,
                                                    batch)
                    loss = float(metrics["loss"])  # sync point + NaN probe
                    if not math.isfinite(loss):
                        raise FloatingPointError(f"non-finite loss {loss}")
                    break
                except (FloatingPointError, RuntimeError) as e:
                    attempt += 1
                    if attempt > self.tcfg.max_step_retries:
                        raise
                    print(f"[trainer] step {step} retry {attempt}: {e}")
            dt = time.perf_counter() - t0
            if dt > self.tcfg.step_timeout_s:
                print(f"[trainer] WARNING straggler step {step}: {dt:.1f}s")
            data_state = DataState(seed=data_state.seed,
                                   step=data_state.step + 1)
            step += 1
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                m = {"loss": loss, "step_time_s": dt,
                     "grad_norm": float(metrics["grad_norm"])}
                history.append((step, m))
                if on_metrics:
                    on_metrics(step, m)
                else:
                    print(f"[trainer] step {step}: loss={loss:.4f} "
                          f"gnorm={m['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if self.ckpt is not None and step % self.tcfg.checkpoint_every == 0:
                self._save(step, named, opt_state, data_state)
        if self.ckpt is not None:
            self._save(self.tcfg.steps, named, opt_state, data_state)
            self.ckpt.wait()
        return params, opt_state, history
