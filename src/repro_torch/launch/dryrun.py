"""Dry-run planning of every (architecture x input shape) cell on the
production mesh, on ``meta`` tensors: no card, no fake devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

For each cell the params, AdamW state, cache and batch are built on
``torch.device("meta")`` in bf16 (float32 for rwkv6, whose WKV kernel takes
float32 params only) and the port's own train step (``loss_fn``,
``torch.autograd.grad``, ``adamw_update``), prefill (``forward`` with
``last_only``) or decode step (``decode_step``) runs under
``utils.op_count.OpCounter``.  The whole-model costs come from the
reference's layer-delta method (``scaled_costs``: 1 and 2 layers of each
stack); the memory figures from one run at full depth.  Per-device figures
divide by the plan's shard factors (``Plan``, ``docs/GPU_PLANNING.md``):
argument bytes exactly, leaf by leaf at its shard shape; flops and bytes by
``dp * tp``; temp bytes by ``dp``.  Collectives come from the policy
(``op_count.collective_bytes``).

Records are JSON, one a cell, with the reference's keys (``status``,
``scaled``, ``memory_analysis``, ``n_devices``, ``mode``,
``model_active_params``, ...), under ``$REPRO_RESULTS_DIR/<mesh>/``
(default ``results/torch_dryrun/``); ``launch/roofline.py`` reads them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.registry import (
    SHAPES,
    ShapeSpec,
    frontend_len,
    get_config,
    list_architectures,
    shape_applicable,
)
from repro_torch.launch.mesh import make_policy, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardingPolicy, mesh_shape, spec_axes
from repro_torch.optim.adamw import adamw_init, adamw_state_specs, adamw_update
from repro_torch.utils.op_count import (
    OpCounter,
    collective_bytes,
    tensor_bytes,
    tensors,
)

RESULTS_DIR = os.environ.get(
    "REPRO_RESULTS_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..",
                 "results", "torch_dryrun"),
)

PARAM_DTYPE = torch.bfloat16
META = torch.device("meta")


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """bf16, as the reference plans; float32 for the rwkv family, whose WKV
    kernel takes float32 inputs only (its decay is float32)."""
    return torch.float32 if cfg.family == "rwkv" else PARAM_DTYPE


def factored_for(cfg: ModelConfig) -> bool:
    """The reference's rule: a factored second moment past 100e9 params."""
    return cfg.total_params > 100e9


# ---------------------------------------------------------------------------
# the plan: what each leaf's shard looks like on the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    spec: tuple        # logical axes
    resolved: tuple    # mesh axes per dim (the spec tuple, padded to rank)
    nbytes: int        # the whole tensor's
    factor: int        # how many shards it is cut into


def _leaf(name, shape, spec, itemsize, pol: ShardingPolicy) -> Leaf:
    resolved = pol.resolve_spec(tuple(shape), spec)
    resolved = resolved + (None,) * (len(shape) - len(resolved))
    sizes = mesh_shape(pol.mesh)
    factor = math.prod(sizes[a] for e in resolved for a in spec_axes(e))
    return Leaf(name, tuple(shape), tuple(spec), resolved,
                math.prod(shape) * itemsize, factor)


def _split(pol: ShardingPolicy, shape, spec, dim: int = 0) -> int:
    """How many ways ``dim`` of a ``shape`` tensor with logical ``spec``
    splits on the mesh."""
    entry = (pol.resolve_spec(tuple(shape), spec) + (None,) * len(shape))[dim]
    return math.prod(mesh_shape(pol.mesh)[a] for a in spec_axes(entry))


@dataclasses.dataclass
class Plan:
    """A cell's sharding plan: the per-leaf shards and the factors the
    per-device figures divide by."""

    cfg: ModelConfig
    shape: ShapeSpec
    policy: ShardingPolicy
    dtype: torch.dtype
    param_leaves: list
    dp: int
    tp: float
    expert_split: int
    vocab_split: int
    kv_seq_split: int

    @property
    def mode(self) -> str:
        return self.shape.mode

    @property
    def mesh_shape(self) -> dict:
        return mesh_shape(self.policy.mesh)

    @property
    def act_bytes(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def batch_per_device(self) -> int:
        return self.shape.global_batch // self.dp

    @property
    def tokens_per_device(self) -> int:
        s = 1 if self.mode == "decode" else self.shape.seq_len
        return self.batch_per_device * s

    @property
    def logit_rows_per_device(self) -> int:
        return self.batch_per_device  # prefill's last position, decode's one

    @property
    def vocab_padded(self) -> int:
        return M.vocab_padded(self.cfg)

    @property
    def v_dim(self) -> int:
        return (self.cfg.mla.v_head_dim if self.cfg.mla is not None
                else self.cfg.head_dim)

    @property
    def n_attn_layers(self) -> int:
        return 0 if self.cfg.family == "rwkv" else self.cfg.n_layers

    @property
    def n_moe_layers(self) -> int:
        return (self.cfg.n_layers - self.cfg.first_k_dense
                if self.cfg.moe is not None else 0)

    @property
    def moe_slot_bytes(self) -> int:
        """Global bytes of the (E, G, C, d) expert slots of one MoE layer
        (the dispatch's grouping and capacity, ``layers.moe_apply``)."""
        mo, cfg = self.cfg.moe, self.cfg
        t = self.shape.global_batch * (1 if self.mode == "decode"
                                       else self.shape.seq_len)
        if self.mode == "decode":
            tg, cap = t, t
        else:
            tg = mo.group_size
            while t % tg:
                tg //= 2
            cap = max(1, -(-int(tg * mo.capacity_factor * mo.top_k)
                           // mo.n_experts))
        return mo.n_experts * (t // tg) * cap * cfg.d_model * self.act_bytes


def make_plan(cfg: ModelConfig, shape: ShapeSpec, pol: ShardingPolicy,
              dtype=None) -> Plan:
    """The plan of ``cfg`` at ``shape`` under ``pol``: each param at its
    shard, the batch split ``dp``, the weights' effective split ``tp``
    (``N / sum(N_leaf / f_leaf)`` over the matrix leaves, ``f_leaf`` the
    split of a leaf's non-fsdp dims) and the expert, vocab and cache-
    sequence splits."""
    dtype = dtype or param_dtype(cfg)
    lm = M.init_params(cfg, device=META, dtype=dtype)
    specs = M.named_param_specs(cfg)
    leaves = [_leaf(name, p.shape, specs[name], p.element_size(), pol)
              for name, p in lm.named_parameters()]
    sizes = mesh_shape(pol.mesh)
    n, n_local = 0, 0.0
    for leaf in leaves:
        if len(leaf.shape) < 2:
            continue
        f = math.prod(sizes[a] for s, e in zip(leaf.spec, leaf.resolved)
                      if s != "fsdp" for a in spec_axes(e))
        numel = math.prod(leaf.shape)
        n += numel
        n_local += numel / f
    b = shape.global_batch
    cache_split = (_split(pol, (b, cfg.n_kv_heads, shape.seq_len, cfg.head_dim),
                          ("batch", "kv_heads", "kv_seq", None), 2)
                   if cfg.mla is None else
                   _split(pol, (b, shape.seq_len, cfg.mla.kv_lora_rank),
                          ("batch", "kv_seq", None), 1))
    return Plan(
        cfg=cfg, shape=shape, policy=pol, dtype=dtype, param_leaves=leaves,
        dp=_split(pol, (b, shape.seq_len), ("batch", None)),
        tp=n / n_local if n_local else 1.0,
        expert_split=(_split(pol, (cfg.moe.n_experts, cfg.d_model,
                                   cfg.moe.d_expert),
                             ("experts", "fsdp", None))
                      if cfg.moe is not None else 1),
        vocab_split=_split(pol, (M.vocab_padded(cfg), cfg.d_model),
                           ("vocab", "embed")),
        kv_seq_split=(1 if cfg.family == "rwkv" or shape.mode != "decode"
                      else cache_split),
    )


# ---------------------------------------------------------------------------
# inputs and steps on meta
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeSpec, dtype) -> dict:
    """The batch as meta tensors: tokens (and labels) int32, a frontend's
    embeddings in the params' type; decode takes one token a row."""
    b, s = shape.global_batch, shape.seq_len

    def ids(*sh):
        return torch.empty(sh, dtype=torch.int32, device=META)

    if shape.mode == "decode":
        return {"tokens": ids(b, 1)}
    out = {"tokens": ids(b, s)}
    if shape.mode == "train":
        out["labels"] = ids(b, s)
    if cfg.frontend != "none":
        out["frontend"] = torch.empty((b, frontend_len(cfg, s), cfg.d_model),
                                      dtype=dtype, device=META)
    return out


def _batch_leaves(batch: dict, pol: ShardingPolicy) -> list[Leaf]:
    return [_leaf(k, v.shape, ("batch",) + (None,) * (v.dim() - 1),
                  v.element_size(), pol) for k, v in batch.items()]


def make_train_step(cfg: ModelConfig, micro_batches: int = 1):
    """The port's training step: the mean of per-micro-batch grads of
    ``loss_fn``, then ``adamw_update`` in place (lr 1e-4, as the
    reference's dry run)."""

    def step(lm, named, opt_state, batch):
        mb = micro_batches
        rows = batch["tokens"].shape[0] // mb
        grads = None
        for i in range(mb):
            micro = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            loss, _ = M.loss_fn(lm, cfg, micro)
            g = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
            grads = (list(g) if grads is None
                     else [a + b for a, b in zip(grads, g)])
            del loss, g
        grads = dict(zip(named, (x / mb for x in grads) if mb > 1 else grads))
        adamw_update(named, grads, opt_state, lr=1e-4)

    return step


def _run(cfg: ModelConfig, shape: ShapeSpec, pol: ShardingPolicy, dtype,
         micro_batches: int = 1):
    """One step of ``cfg`` at ``shape`` on meta under an ``OpCounter``.
    Returns (counter, argument leaves by group)."""
    lm = M.init_params(cfg, device=META, dtype=dtype)
    batch = input_specs(cfg, shape, dtype)
    specs = M.named_param_specs(cfg)
    args = {"params": [_leaf(n, p.shape, specs[n], p.element_size(), pol)
                       for n, p in lm.named_parameters()],
            "batch": _batch_leaves(batch, pol)}
    counter = OpCounter()
    if shape.mode == "train":
        lm.requires_grad_(True)
        named = dict(lm.named_parameters())
        opt = adamw_init(named, factored=factored_for(cfg))
        o_specs = adamw_state_specs(specs, named, factored=factored_for(cfg))
        opt_leaves = [_leaf("step", (), (), 4, pol)]
        for tree, spec_tree, tag in ((opt.m, o_specs.m, "m"),
                                     (opt.v, o_specs.v, "v")):
            for name, x in tree.items():
                parts = zip(x, spec_tree[name]) if isinstance(x, tuple) \
                    else ((x, spec_tree[name]),)
                opt_leaves += [_leaf(f"{tag}.{name}", t.shape, s,
                                     t.element_size(), pol) for t, s in parts]
        args["opt_state"] = opt_leaves
        counter.track((named, opt, batch))
        with counter:
            make_train_step(cfg, micro_batches)(lm, named, opt, batch)
    elif shape.mode == "prefill":
        counter.track((list(lm.parameters()), batch))
        with counter, torch.no_grad():
            M.forward(lm, cfg, batch["tokens"], frontend=batch.get("frontend"),
                      last_only=True)
    else:
        enc = frontend_len(cfg, shape.seq_len) if cfg.n_encoder_layers else 0
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, dtype,
                             META, enc_memory_len=enc)
        c_specs = M.cache_specs(cfg)
        args["cache"] = _cache_leaves(cache, c_specs, pol)
        counter.track((list(lm.parameters()), cache, batch))
        with counter:
            M.decode_step(lm, cfg, cache, batch["tokens"], shape.seq_len - 1)
    return counter, args


def _cache_leaves(cache, specs, pol, prefix="") -> list[Leaf]:
    if isinstance(cache, dict):
        return [x for k in cache for x in _cache_leaves(
            cache[k], specs[k], pol, f"{prefix}{k}.")]
    return [_leaf(prefix[:-1], cache.shape, specs, cache.element_size(), pol)]


# ---------------------------------------------------------------------------
# layer-delta scaling (the reference's ``scaled_costs``)
# ---------------------------------------------------------------------------


def _stack_counts(cfg: ModelConfig) -> dict:
    counts = {"layers": cfg.n_layers - cfg.first_k_dense}
    if cfg.first_k_dense:
        counts["dense_layers"] = cfg.first_k_dense
    if cfg.n_encoder_layers:
        counts["encoder"] = cfg.n_encoder_layers
    return counts


def _with_counts(cfg: ModelConfig, counts: dict) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        n_layers=counts["layers"] + counts.get("dense_layers", 0),
        first_k_dense=counts.get("dense_layers", 0),
        n_encoder_layers=counts.get("encoder", 0),
    )


def _costs(cfg, shape, pol, dtype, micro_batches) -> dict:
    plan = make_plan(cfg, shape, pol, dtype)
    counter, _ = _run(cfg, shape, pol, dtype, micro_batches)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": collective_bytes(plan),
            "op_histogram": dict(counter.histogram)}


def scaled_costs(cfg: ModelConfig, shape: ShapeSpec, pol: ShardingPolicy,
                 micro_batches: int = 1, dtype=None) -> dict:
    """Whole-model costs by layer-count deltas: plan 1 layer of every stack
    and 2 of each in turn, and scale, ``total = base + sum_s (count_s - 1)
    (cost(2_s) - cost(base))``, exact for stacks of equal layers.  Flops and
    bytes are global; the ``*_per_device`` figures divide them by the plan's
    ``dp * tp``, and the collectives are per device already."""
    dtype = dtype or param_dtype(cfg)
    true_counts = _stack_counts(cfg)
    base_counts = {k: 1 for k in true_counts}
    variants = {"base": base_counts}
    for k in true_counts:
        variants[k] = {**base_counts, k: 2}
    costs = {name: _costs(_with_counts(cfg, counts), shape, pol, dtype,
                          micro_batches)
             for name, counts in variants.items()}

    def scale(metric_fn):
        base = metric_fn(costs["base"])
        return base + sum((n - 1) * (metric_fn(costs[k]) - base)
                          for k, n in true_counts.items())

    plan = make_plan(cfg, shape, pol, dtype)
    split = plan.dp * plan.tp
    flops = scale(lambda c: c["flops"])
    nbytes = scale(lambda c: c["bytes"])
    out = {
        "flops_global": flops,
        "bytes_global": nbytes,
        "flops_per_device": flops / split,
        "bytes_per_device": nbytes / split,
        "collective_bytes_per_device": scale(
            lambda c: float(c["collectives"].get("total", 0))),
        "dp": plan.dp,
        "tp": plan.tp,
    }
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        out[f"coll_{kind}"] = scale(
            lambda c, k=kind: float(c["collectives"].get(k, 0)))
    out["per_layer"] = {
        k: {"flops": costs[k]["flops"] - costs["base"]["flops"],
            "coll": float(costs[k]["collectives"].get("total", 0))
            - float(costs["base"]["collectives"].get("total", 0))}
        for k in true_counts
    }
    out["base_op_histogram"] = costs["base"]["op_histogram"]
    return out


def memory_analysis(cfg: ModelConfig, shape: ShapeSpec, pol: ShardingPolicy,
                    micro_batches: int = 1, dtype=None) -> dict:
    """Per-device memory of the full-depth step: argument bytes leaf by leaf
    at their shard shapes (``argument_parts`` by group: params, opt_state,
    cache, batch), the peak of live bytes and the temp bytes above the
    arguments (both over the batch split ``dp``), and the global peak."""
    dtype = dtype or param_dtype(cfg)
    plan = make_plan(cfg, shape, pol, dtype)
    counter, args = _run(cfg, shape, pol, dtype, micro_batches)
    parts = {k: sum(leaf.nbytes // leaf.factor for leaf in leaves)
             for k, leaves in args.items()}
    global_args = sum(leaf.nbytes for leaves in args.values()
                      for leaf in leaves)
    temp = max(counter.peak - global_args, 0) // plan.dp
    arg = sum(parts.values())
    return {"argument_size_in_bytes": arg,
            "temp_size_in_bytes": temp,
            "peak_memory_in_bytes": arg + temp,
            "global_peak_in_bytes": counter.peak,
            "argument_parts": parts}


def live_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (a model's
    params, an optimizer state): what ``argument_parts`` plans for them."""
    seen = {}
    for t in tensors(tree):
        seen[t.untyped_storage().data_ptr(), t.device] = tensor_bytes(t)
    return sum(seen.values())


# ---------------------------------------------------------------------------
# the dry run proper
# ---------------------------------------------------------------------------


def mesh_name(multi_pod: bool) -> str:
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             save: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = shape_applicable(cfg, shape)
    record: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "mode": shape.mode,
        "model_total_params": cfg.total_params,
        "model_active_params": cfg.active_params_per_token,
    }
    if skip:
        record["status"] = "skipped"
        record["skip_reason"] = skip
        if save:
            _save(record)
        return record

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    pol = make_policy(cfg, mesh)
    dtype = param_dtype(cfg)
    record["param_dtype"] = str(dtype).removeprefix("torch.")
    record["n_devices"] = math.prod(mesh.values())
    record["memory_analysis"] = memory_analysis(cfg, shape, pol, dtype=dtype)
    record["scaled"] = scaled_costs(cfg, shape, pol, dtype=dtype)
    record["plan_seconds"] = round(time.time() - t0, 1)
    record["status"] = "ok"
    if save:
        _save(record)
    return record


def _save(record: dict) -> str:
    d = os.path.abspath(os.path.join(RESULTS_DIR, record["mesh"]))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{record['arch']}__{record['shape']}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def cell_done(arch, shape_name, multi_pod) -> bool:
    path = os.path.abspath(os.path.join(
        RESULTS_DIR, mesh_name(multi_pod), f"{arch}__{shape_name}.json"))
    if not os.path.exists(path):
        return False
    with open(path) as f:
        rec = json.load(f)
    return rec.get("status") in ("ok", "skipped")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = list_architectures() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    failures = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                if not args.force and cell_done(arch, shape, mp):
                    print(f"[cached ] {tag}")
                    continue
                try:
                    rec = run_cell(arch, shape, mp)
                    if rec["status"] == "skipped":
                        print(f"[skipped] {tag}: {rec['skip_reason']}")
                        continue
                    sc, mem = rec["scaled"], rec["memory_analysis"]
                    print(f"[ok     ] {tag}: plan={rec['plan_seconds']}s "
                          f"flops/dev={sc['flops_per_device']:.3e} "
                          f"coll/dev={sc['collective_bytes_per_device']:.3e}B "
                          f"mem/dev={mem['peak_memory_in_bytes'] / 1e9:.2f}GB")
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append((tag, str(e)))
                    print(f"[FAIL   ] {tag}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures")
        raise SystemExit(1)
    print("\nall requested dry-run cells passed")


if __name__ == "__main__":
    main()
