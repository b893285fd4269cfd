"""The port's planning tools (``repro_torch.launch.{dryrun,roofline,perf}``
and ``repro_torch.utils.op_count``) on the CPU, on ``meta`` tensors.

* the reference's ``tests/test_analysis_tools.py`` roofline cases at the
  H100's constants: each term exactly 1 s, dominance, ``useful_ratio`` 1,
  decode at forward flops; the layer-delta formula, by hand and through
  the port's ``scaled_costs``;
* the port's ``total_params`` and ``active_params_per_token`` equal the
  reference's for the ten configs;
* planned per-device argument bytes of granite-3-2b train_4k and
  deepseek-v3-671b decode_32k equal a hand sum over the resolved shard
  shapes;
* the counted forward flops of a 1-layer reduced granite are within 1 % of
  2 N tokens plus attention's 2 B H S^2 (D + Dv); the hand kernels count at
  their plain versions' flops, and the peak of live bytes;
* the ``ce_chunk8`` variant lowers granite train's planned temp bytes, and
  a config field the port lacks raises ``KeyError``;
* a skipped cell carries the reference's reason; the collective rules.
"""

import dataclasses
import math

import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs.registry import SHAPES as R_SHAPES
from repro.configs.registry import shape_applicable as r_shape_applicable
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.configs.registry import SHAPES, ShapeSpec
from repro_torch.launch import dryrun, perf, roofline
from repro_torch.launch.mesh import make_policy, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.sharding import ShardingPolicy, shard_shape
from repro_torch.utils.op_count import OpCounter, collective_bytes

MESH = make_production_mesh()


class TestRooflineMath:
    def _rec(self, flops, bytes_, coll, mode="train", n_dev=256):
        return {
            "scaled": {"flops_per_device": flops, "bytes_per_device": bytes_,
                       "collective_bytes_per_device": coll},
            "n_devices": n_dev, "mode": mode,
            "shape": "train_4k" if mode == "train" else "decode_32k",
            "model_active_params": 1e9,
        }

    def test_terms_and_dominance(self):
        assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW,
                roofline.HBM_BYTES) == (989e12, 3.35e12, 450e9, 80e9)
        a = roofline.analyze_record(self._rec(989e12, 3.35e12, 450e9))
        for term in ("compute_s", "memory_s", "collective_s"):
            assert abs(a[term] - 1.0) < 1e-9
        b = roofline.analyze_record(self._rec(1e12, 3.35e12 * 5, 1e9))
        assert b["dominant"] == "memory"
        c = roofline.analyze_record(self._rec(1e12, 1e9, 450e9 * 3))
        assert c["dominant"] == "collective" and c["bound_s"] == pytest.approx(3)
        # a float32 plan takes the float32 peak
        f32 = roofline.analyze_record({**self._rec(67e12, 0, 0),
                                       "param_dtype": "float32"})
        assert abs(f32["compute_s"] - 1.0) < 1e-9

    def test_useful_ratio_train(self):
        tokens = 4096 * 256
        model = 6 * 1e9 * tokens
        a = roofline.analyze_record(self._rec(model / 256, 1e9, 0))
        assert abs(a["useful_ratio"] - 1.0) < 1e-6

    def test_decode_uses_forward_flops(self):
        a = roofline.analyze_record(self._rec(1e9, 1e9, 0, mode="decode"))
        assert abs(a["model_flops"] - 2 * 1e9 * 128) < 1


class TestScaledCosts:
    def test_delta_scaling_formula(self):
        per = {"layers": 7.0, "dense_layers": 3.0}
        base_fixed = 11.0

        def cost(counts):
            return base_fixed + sum(counts[k] * per[k] for k in counts)

        true_counts = {"layers": 58, "dense_layers": 3}
        base_counts = {k: 1 for k in true_counts}
        c_base = cost(base_counts)
        total = c_base + sum((n - 1) * (cost({**base_counts, k: 2}) - c_base)
                             for k, n in true_counts.items())
        assert abs(total - cost(true_counts)) < 1e-9

    def test_port_scaled_costs_reproduce_a_linear_cost(self, monkeypatch):
        """deepseek-v3's three stacks (58 MoE, 3 dense) through the port's
        ``scaled_costs`` with a linear stand-in for the meta run."""
        per = {"layers": 7, "dense_layers": 3}

        def fake(cfg, shape, pol, dtype, mb):
            n = cfg.n_layers - cfg.first_k_dense
            v = 11 + per["layers"] * n + per["dense_layers"] * cfg.first_k_dense
            return {"flops": v, "bytes": 2 * v,
                    "collectives": {"total": 3 * v, "all-reduce": 3 * v},
                    "op_histogram": {}}

        monkeypatch.setattr(dryrun, "_costs", fake)
        cfg = get_config("deepseek-v3-671b")
        pol = ShardingPolicy(mesh={"data": 1, "model": 1})
        sc = dryrun.scaled_costs(cfg, SHAPES["decode_32k"], pol)
        want = 11 + 7 * 58 + 3 * 3
        assert sc["flops_global"] == want and sc["bytes_global"] == 2 * want
        assert sc["flops_per_device"] == want  # a (1, 1) mesh splits nothing
        assert sc["collective_bytes_per_device"] == 3 * want
        assert sc["per_layer"] == {"layers": {"flops": 7, "coll": 21.0},
                                   "dense_layers": {"flops": 3, "coll": 9.0}}


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_counts_equal_reference(arch):
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    assert cfg.total_params == r_cfg.total_params
    assert cfg.active_params_per_token == r_cfg.active_params_per_token


def _hand_bytes(shapes_specs, pol):
    return sum(math.prod(shard_shape(shape, pol.resolve_spec(shape, spec),
                                     pol.mesh)) * size
               for shape, spec, size in shapes_specs)


def test_train_argument_bytes_equal_hand_sum():
    """granite-3-2b train_4k: bf16 params, float32 m and v, the int32 step,
    int32 tokens and labels, each at its shard shape on the (16, 16) pod."""
    cfg = get_config("granite-3-2b")
    pol = make_policy(cfg, MESH)
    lm = M.init_params(cfg, device="meta", dtype=torch.bfloat16)
    specs = M.named_param_specs(cfg)
    params = [(tuple(p.shape), specs[n], p.element_size())
              for n, p in lm.named_parameters()]
    opt = [(s, sp, 4) for s, sp, _ in params] * 2 + [((), (), 4)]
    batch = [((256, 4096), ("batch", None), 4)] * 2
    mem = dryrun.memory_analysis(cfg, SHAPES["train_4k"], pol)
    parts = mem["argument_parts"]
    assert parts["params"] == _hand_bytes(params, pol)
    assert parts["opt_state"] == _hand_bytes(opt, pol)
    assert parts["batch"] == _hand_bytes(batch, pol) == 2 * 16 * 4096 * 4
    assert mem["argument_size_in_bytes"] == sum(parts.values())
    assert mem["temp_size_in_bytes"] > 0


def test_decode_argument_bytes_equal_hand_sum():
    """deepseek-v3-671b decode_32k (FSDP on): params, the two-stack MLA
    cache and the (128, 1) tokens at their shard shapes."""
    cfg = get_config("deepseek-v3-671b")
    pol = make_policy(cfg, MESH)
    assert pol.enable_fsdp
    lm = M.init_params(cfg, device="meta", dtype=torch.bfloat16)
    specs = M.named_param_specs(cfg)
    params = [(tuple(p.shape), specs[n], p.element_size())
              for n, p in lm.named_parameters()]
    cache = M.init_cache(cfg, 128, 32768, torch.bfloat16, "meta")
    c_specs = M.cache_specs(cfg)
    cache_leaves = [(tuple(cache[s]["attn"][k].shape), c_specs[s]["attn"][k], 2)
                    for s in ("dense_layers", "layers")
                    for k in ("ckv", "k_rope")]
    mem = dryrun.memory_analysis(cfg, SHAPES["decode_32k"], pol)
    parts = mem["argument_parts"]
    assert parts["params"] == _hand_bytes(params, pol)
    assert parts["cache"] == _hand_bytes(cache_leaves, pol)
    assert parts["batch"] == 128 // 16 * 4
    assert mem["argument_size_in_bytes"] == sum(parts.values())


def test_forward_flops_equal_analytic():
    """A 1-layer reduced granite forward over (2, 24) tokens: every matmul
    weight times 2 per token, plus the attention kernel's 2 B H S^2 (D +
    Dv) (its plain version's flops), within 1 %."""
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), n_layers=1,
                              attn_impl="auto")
    lm = M.init_params(cfg, device="meta")
    b, s = 2, 24
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    counter = OpCounter()
    counter.track(list(lm.parameters()))
    with counter, torch.no_grad():
        M.forward(lm, cfg, tokens)
    # the logits read embed (tied) or unembed; the lookup is no matmul
    n_matmul = sum(p.numel() for n, p in lm.named_parameters()
                   if p.dim() >= 2 and (n != "embed" or cfg.tie_embeddings))
    attn = 2 * b * cfg.n_heads * s * s * 2 * cfg.head_dim
    want = 2 * n_matmul * b * s + attn
    assert abs(counter.flops - want) / want < 0.01
    assert counter.histogram["flash_attention"] == 1
    assert counter.histogram["mm"] + counter.histogram["bmm"] >= 7
    params = sum(p.numel() * 4 for p in lm.parameters())
    assert counter.peak >= params + b * s * M.vocab_padded(cfg) * 4
    assert counter.bytes > params


def test_kernels_count_their_plain_flops_and_bytes():
    q = torch.empty((2, 8, 16, 32), device="meta")
    k = v = torch.empty((2, 2, 40, 32), device="meta")
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    rkvw = (torch.empty((1, 2, 5, 8), device="meta"),) * 4
    u = torch.empty((2, 8), device="meta")
    real = fa_ops._forward
    with OpCounter() as counter:
        out = fa_ops.flash_attention(q, k, v, True, None, 24, 40)
        o, st = wkv_ops.wkv6(*rkvw, u)
    assert fa_ops._forward is real  # restored
    assert out.shape == (2, 8, 16, 32) and out.device.type == "meta"
    assert o.shape == (1, 2, 5, 8) and st.dtype == torch.float32
    assert counter.flops == 2 * 2 * 8 * 16 * 40 * 64 + 7 * 2 * 5 * 8 * 8
    assert counter.bytes == 4 * (2 * 8 * 16 * 32 * 2 + 2 * 2 * 40 * 32 * 2
                                 + 4 * 1 * 2 * 5 * 8 + 2 * 8 + 1 * 2 * 5 * 8
                                 + 1 * 2 * 8 * 8)
    assert counter.histogram == {"flash_attention": 1, "wkv6": 1}


def test_ce_chunk8_lowers_train_temp_bytes():
    """granite-3-2b training at train_4k's batch of 256 and 128 tokens a
    row, where the (B, S, V) logits and their grad set the peak: streaming
    the CE lowers the planned temp bytes.  At train_4k itself the peak is
    the plain attention VJP's (B, H, S, S) scores (``FlashAttention`` has
    no backward kernel), which ``ce_chunk8`` does not touch, and at (4,
    512) it is the optimizer step's grads; the plans are equal there."""
    cfg = get_config("granite-3-2b")
    shape = ShapeSpec("train_128", 128, 256, "train")
    pol = make_policy(cfg, MESH)
    base = dryrun.memory_analysis(cfg, shape, pol)
    chunk_cfg, chunk_pol, mb = perf.apply_variant(cfg, make_policy(cfg, MESH),
                                                  ["ce_chunk8"])
    assert chunk_cfg.ce_chunk == M.vocab_padded(cfg) // 8 and mb == 1
    chunk = dryrun.memory_analysis(chunk_cfg, shape, chunk_pol)
    assert chunk["temp_size_in_bytes"] < base["temp_size_in_bytes"]
    assert chunk["argument_size_in_bytes"] == base["argument_size_in_bytes"]
    rec = perf.run_variant("granite-3-2b", "decode_32k", "ce_chunk8",
                           save=False)
    assert rec["dominant"] in rec["terms"]  # "memory_s", as the reference names it


def test_variant_field_the_port_lacks_raises_key_error(monkeypatch):
    monkeypatch.setitem(perf.VARIANTS, "no_such_field",
                        {"cfg": {"no_such_field": 1}})
    with pytest.raises(KeyError, match="no_such_field"):
        perf.apply_variant(get_config("granite-3-2b"),
                           make_policy(get_config("granite-3-2b"), MESH),
                           ["no_such_field"])
    assert set(perf.VARIANTS) >= {
        "fsdp_pure", "remat_dots", "remat_none", "moe_group_2048",
        "moe_group_128", "kv_seq_sharded", "kv_seq_replicated",
        "mla_absorbed", "ce_chunk8", "moe_gather", "seq_parallel",
        "microbatch8"}


def test_skipped_cell_has_reference_reason():
    rec = dryrun.run_cell("granite-3-2b", "long_500k", False, save=False)
    assert rec["status"] == "skipped"
    assert rec["skip_reason"] == r_shape_applicable(
        r_get_config("granite-3-2b"), R_SHAPES["long_500k"])
    assert rec["model_active_params"] == r_get_config(
        "granite-3-2b").active_params_per_token


def test_collective_rules():
    """Nothing crosses a (1, 1) mesh; on the pod, granite train has TP
    all-reduces and DP grad all-reduces, deepseek train FSDP all-gathers
    and reduce-scatters and MoE all-to-alls."""
    shape = ShapeSpec("t", 128, 32, "train")
    cfg = get_config("granite-3-2b")
    one = dryrun.make_plan(cfg, shape, make_policy(cfg, {"data": 1,
                                                         "model": 1}))
    assert collective_bytes(one) == {"total": 0, "count": 0}
    pod = collective_bytes(dryrun.make_plan(cfg, shape, make_policy(cfg, MESH)))
    assert pod["all-reduce"] > 0 and "all-gather" not in pod
    ds = get_config("deepseek-v3-671b")
    plan = dryrun.make_plan(ds, shape, make_policy(ds, MESH))
    got = collective_bytes(plan)
    assert got["all-gather"] > 0 and got["reduce-scatter"] > 0
    assert got["all-to-all"] > 0 and plan.expert_split == 16
    assert got["total"] == sum(v for k, v in got.items()
                               if k not in ("total", "count"))
