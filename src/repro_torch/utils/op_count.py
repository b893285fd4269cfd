"""Counts of a step's work without running it: the port's counterpart of
``repro.utils.hlo_parse`` (which parses XLA's compiled module).

``OpCounter`` is a ``TorchDispatchMode``.  A step run under it on ``meta``
tensors (shapes and dtypes, no memory) records

* ``flops``: matmuls and attention by ``torch.utils.flop_counter``'s
  formulas (2 m n k a product); elementwise ops count nothing, as in
  those formulas.  The hand kernels (``flash_attention``, ``wkv6``,
  ``wkv6_backward``) have no meta version: under the counter each wrapper's
  plain version is stood in by its output shapes, and its launch counts the
  plain version's arithmetic (``kernel_flops``);
* ``bytes``: per aten op that is not a view, every input and output tensor
  once; per kernel launch, its inputs read once and its outputs written
  once.  An upper bound on device-memory traffic, with the caveat the
  reference states for XLA's "bytes accessed": reuse in caches and
  registers is not discounted;
* ``peak``: the most bytes of tensor storage alive at once, from the op
  that makes a storage until its last reference dies; ``track`` adds
  storages made before the step (its arguments);
* ``histogram``: how many times each aten op (and each kernel) ran (the
  reference's ``op_histogram``).

``collective_bytes(plan)`` counts the collectives a sharded step would
issue, from the sharding policy, with the rules of ``docs/GPU_PLANNING.md``
(the port has no SPMD partitioner that would insert them).
"""

from __future__ import annotations

import math
import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# ops that allocate without moving a byte
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided, torch.ops.aten.lift_fresh}

# arithmetic a state cell and step of the plain WKV forward (a product, a
# scaled product, a sum, the weighted sum into o, the decay and the add)
# and backward (``chip_smoke.py``'s ``WKV_BWD_OPS``)
WKV_FWD_OPS = 7
WKV_BWD_OPS = 14


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors(tree) -> list[torch.Tensor]:
    """The tensors among the leaves of a nested tree."""
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def kernel_flops(name: str, args) -> int:
    """The plain version's arithmetic for one launch of a hand kernel:
    attention's two products over every (query, key) pair, 2 B Hq Sq Skv
    (D + Dv), as ``torch.utils.flop_counter`` counts ``mha_plain``'s
    einsums; the WKV recurrence's 7 (forward) or 14 (backward) operations
    per state cell and step."""
    if name == "flash_attention":
        q, k, v = args[:3]
        b, hq, sq, d = q.shape
        return 2 * b * hq * sq * k.shape[2] * (d + v.shape[3])
    r, v = args[0], args[2]
    b, h, t, dk = r.shape
    ops = WKV_FWD_OPS if name == "wkv6" else WKV_BWD_OPS
    return ops * b * h * t * dk * v.shape[-1]


def _kernel_outputs(name: str, args):
    """Empty outputs of a kernel's shapes and dtypes (the wrappers' own)."""
    if name == "flash_attention":
        q, _, v = args[:3]
        return q.new_empty((*q.shape[:3], v.shape[3]))
    r, k, v, w, u, state0 = args[:6]
    b, h, _, dk = r.shape
    state = r.new_empty((b, h, dk, v.shape[-1]), dtype=torch.float32)
    if name == "wkv6":
        return r.new_empty((*r.shape[:3], v.shape[-1])), state
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(w), torch.empty_like(u),
            None if state0 is None else state)


class OpCounter(TorchDispatchMode):
    """Flops, bytes, peak live bytes and an op histogram of what runs under
    it (see the module docstring).  Use it as a context manager around a
    step on ``meta`` tensors."""

    KERNELS = ((flash_ops, "_forward", "flash_attention"),
               (wkv_ops, "_forward", "wkv6"),
               (wkv_ops, "wkv6_backward", "wkv6_backward"))

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.histogram: Counter = Counter()
        self._storages = WeakIdKeyDictionary()
        self._quiet = 0
        self._saved = []

    # -- storage accounting --------------------------------------------------

    def _release(self, n: int, _ref) -> None:
        self.live -= n

    def track(self, tree) -> None:
        """Count the storages of the tensors in ``tree`` as live (each once)."""
        for t in tensors(tree):
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = weakref.ref(
                st, lambda ref, n=n: self._release(n, ref))
            self.live += n
        self.peak = max(self.peak, self.live)

    # -- hand kernels ----------------------------------------------------------

    def _kernel(self, name: str, real):
        def call(*args):
            if args[0].device.type != "meta":
                return real(*args)
            self._quiet += 1
            try:
                out = _kernel_outputs(name, args)
            finally:
                self._quiet -= 1
            self.flops += kernel_flops(name, args)
            self.bytes += sum(map(tensor_bytes, tensors(args) + tensors(out)))
            self.histogram[name] += 1
            self.track(out)
            return out
        return call

    def __enter__(self):
        for module, attr, name in self.KERNELS:
            real = getattr(module, attr)
            self._saved.append((module, attr, real))
            setattr(module, attr, self._kernel(name, real))
        return super().__enter__()

    def __exit__(self, *exc):
        while self._saved:
            module, attr, real = self._saved.pop()
            setattr(module, attr, real)
        return super().__exit__(*exc)

    # -- aten ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.bytes += sum(map(tensor_bytes,
                                  tensors((args, kwargs)) + tensors(out)))
        self.histogram[packet.__name__] += 1
        self.track(out)
        return out


# ---------------------------------------------------------------------------
# collectives from the sharding plan
# ---------------------------------------------------------------------------


def collective_bytes(plan) -> dict:
    """Output bytes per device of the collectives one step of ``plan`` (a
    ``launch.dryrun.Plan``) would issue on its mesh: ``{kind: bytes, ...,
    "total": bytes, "count": n_ops}``, the return shape of the reference's
    ``hlo_parse.collective_bytes``.  The rules (``docs/GPU_PLANNING.md``):

    * FSDP: an all-gather of each fsdp-sharded param per forward pass (2 in
      training: the forward and the recompute or backward; 1 otherwise) and
      a reduce-scatter of its grad in training;
    * data parallelism: an all-reduce of every other grad's local shard in
      training when the batch splits;
    * tensor parallelism: an all-reduce of each row-parallel matrix's
      output, (tokens, d) in the activations' type, per pass (forward,
      recompute when remat is on, backward);
    * MoE: a dispatch and a combine all-to-all a layer and pass of the
      device's share of the (E, G, C, d) slots when the experts split;
    * vocab parallelism: the embedding lookup's all-reduce of (tokens, d);
      in training 3 float32 CE statistics a token and the backward
      all-reduce of (tokens, d); otherwise an all-gather of the returned
      float32 logits;
    * decode with a split ``kv_seq``: an all-reduce a layer of each query
      head's partial output and two float32 softmax statistics.
    """
    cfg, pol, mesh = plan.cfg, plan.policy, plan.mesh_shape
    train = plan.mode == "train"
    act = plan.act_bytes
    passes = (2 + (cfg.remat != "none")) if train else 1
    tokens = plan.tokens_per_device
    out: dict = defaultdict(int)
    count = 0

    def add(kind, nbytes, n=1):
        nonlocal count
        if nbytes and n:
            out[kind] += nbytes * n
            count += n

    for leaf in plan.param_leaves:
        spec, resolved = leaf.spec, leaf.resolved
        fsdp_axes = {a for s, e in zip(spec, resolved) if s == "fsdp"
                     for a in ((e,) if isinstance(e, str) else (e or ()))}
        fsdp = math.prod(mesh[a] for a in fsdp_axes)
        local = leaf.nbytes // leaf.factor          # fully sharded shard
        if fsdp > 1:
            add("all-gather", local * fsdp, 2 if train else 1)
            if train:
                add("reduce-scatter", local)
        elif train and plan.dp > 1:
            add("all-reduce", local)
        # row-parallel: output axis fsdp, an input axis split over heads/ff
        row = spec[-1] == "fsdp" and any(
            s in ("heads", "ff") and e is not None
            for s, e in zip(spec[:-1], resolved))
        if row:
            add("all-reduce", tokens * cfg.d_model * act, passes)

    if cfg.moe is not None and plan.expert_split > 1:
        ein = plan.moe_slot_bytes // (plan.dp * plan.expert_split)
        add("all-to-all", ein, 2 * passes * plan.n_moe_layers)

    if plan.vocab_split > 1:
        emb = tokens * cfg.d_model * act
        add("all-reduce", emb)
        if train:
            add("all-reduce", tokens * 3 * 4)
            add("all-reduce", emb)
        else:
            add("all-gather", plan.logit_rows_per_device * plan.vocab_padded
                * 4)

    if plan.mode == "decode" and plan.kv_seq_split > 1:
        per_layer = plan.batch_per_device * cfg.n_heads * (plan.v_dim + 2) * 4
        add("all-reduce", per_layer, plan.n_attn_layers)

    result = {k: int(v) for k, v in out.items()}
    result["total"] = sum(v for k, v in result.items() if k in _COLLECTIVES)
    result["count"] = count
    return result
