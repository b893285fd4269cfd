"""The port's sharding policy and logical-axis trees
(``repro_torch.models.sharding``, ``models.model.param_specs`` /
``cache_specs``, ``optim.adamw_state_specs``, ``launch.mesh``) against the
reference's.

* the reference's four ``TestPolicyResolution`` cases, on a mesh dict and
  on the reference's ``_MeshStub``-style object;
* for each of the ten architectures, with FSDP on and off: the port's
  ``param_specs`` equal the reference's ``init_params`` spec tree leaf for
  leaf, and ``resolve_spec`` gives the reference's ``PartitionSpec`` on
  every leaf at the (16, 16) mesh, on the shapes of ``jax.eval_shape`` of
  the reference's ``init_params`` (exact);
* the AdamW state's specs, factored and not, and ``cache_specs`` at a
  decode cell, likewise;
* ``shard`` is the identity, ``shard_shape``, ``resolve_tree``, and the
  production mesh and its 8e9-parameter FSDP threshold.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.launch.mesh import FSDP_PARAM_THRESHOLD as R_THRESHOLD
from repro.models import model as RM
from repro.models.sharding import ShardingPolicy as RPolicy
from repro.optim.adamw import adamw_state_specs as r_adamw_state_specs
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch.mesh import (
    FSDP_PARAM_THRESHOLD,
    make_policy,
    make_production_mesh,
)
from repro_torch.models import model as M
from repro_torch.models.sharding import (
    ShardingPolicy,
    current_policy,
    resolve_tree,
    shard,
    shard_shape,
    use_policy,
)
from repro_torch.optim import adamw_state_specs

MESH = {"data": 16, "model": 16}


class _MeshStub:
    def __init__(self, shape_map):
        self.shape = shape_map


def _is_spec(s):
    return isinstance(s, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in s)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict / NamedTuple / tuple-of-specs."""
    if _is_spec(tree) or hasattr(tree, "shape"):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], prefix + (k,))]
    return [x for i, t in enumerate(tree) for x in _leaves(t, prefix + (i,))]


class TestPolicyResolution:
    @pytest.fixture(params=["dict", "stub"])
    def pol(self, request):
        return ShardingPolicy(mesh=dict(MESH) if request.param == "dict"
                              else _MeshStub(dict(MESH)))

    def test_divisible_dims_shard(self, pol):
        assert pol.resolve_spec((256, 1024), ("batch", "ff")) == ("data",
                                                                  "model")

    def test_nondivisible_falls_back_to_replication(self, pol):
        # hymba's 25 heads on a 16-way model axis replicate, not crash
        assert pol.resolve_spec((2048, 25, 64), ("fsdp", "heads", None)) == ()

    def test_axis_used_once(self, pol):
        spec = pol.resolve_spec((16, 8, 32768, 128),
                                ("batch", "kv_heads", "kv_seq", None))
        flat = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        assert len(flat) == len(set(flat))

    def test_fsdp_gated(self, pol):
        pol.enable_fsdp = False
        assert pol.resolve_spec((4096, 4096), ("fsdp", "ff")) == (None, "model")
        pol.enable_fsdp = True
        assert pol.resolve_spec((4096, 4096), ("fsdp", "ff")) == ("data",
                                                                  "model")


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    """(shapes, specs) of the reference's init_params, by eval_shape."""
    cfg = r_get_config(arch)
    captured = {}

    def init(key):
        p, s = RM.init_params(key, cfg, jnp.bfloat16)
        captured["specs"] = s
        return p

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, captured["specs"]


def _policies(enable_fsdp):
    ref = RPolicy(mesh=_MeshStub(dict(MESH)))
    port = ShardingPolicy(mesh=dict(MESH))
    ref.enable_fsdp = port.enable_fsdp = enable_fsdp
    return ref, port


@pytest.mark.parametrize("fsdp", [False, True], ids=["fsdp_off", "fsdp_on"])
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_specs_resolve_as_reference(arch, fsdp):
    shapes, r_specs = ref_params(arch)
    specs = M.param_specs(get_config(arch))
    got, want = _leaves(specs), _leaves(r_specs)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [s for _, s in got] == [s for _, s in want]
    ref, port = _policies(fsdp)
    for (path, spec), (_, shaped) in zip(got, _leaves(shapes)):
        assert port.resolve_spec(shaped.shape, spec) == tuple(
            ref.resolve_spec(shaped.shape, spec)), path
    # the resolved tree, at once
    tree = resolve_tree(specs, port, shapes)
    assert [p for p, _ in _leaves(tree)] == [p for p, _ in got]
    assert tree["embed"] == port.resolve_spec(shapes["embed"].shape,
                                              ("vocab", "embed"))


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_adamw_state_specs_equal_reference(arch, factored):
    shapes, r_specs = ref_params(arch)
    want = r_adamw_state_specs(r_specs, shapes, factored=factored)
    got = adamw_state_specs(M.param_specs(get_config(arch)), shapes,
                            factored=factored)
    assert got.step == want.step == ()
    assert _leaves(got.m) == _leaves(want.m)
    assert _leaves(got.v) == _leaves(want.v)
    # on the port's own named params (meta) the factored leaves pair up
    cfg = get_config(arch).reduced()
    named = dict(M.init_params(cfg, device="meta").named_parameters())
    per = adamw_state_specs(M.named_param_specs(cfg), named,
                            factored=factored)
    assert set(per.v) == set(named)


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b",
                                  "hymba-1.5b", "seamless-m4t-large-v2",
                                  "rwkv6-7b"])
def test_cache_specs_resolve_as_reference(arch):
    """At decode_32k's (128, 32,768) cache."""
    r_cfg, cfg = r_get_config(arch), get_config(arch)
    enc = 64 if r_cfg.n_encoder_layers else 0
    shapes = jax.eval_shape(lambda: RM.init_cache(
        r_cfg, 128, 32768, jnp.bfloat16, enc_memory_len=enc)[0])
    r_specs = RM.init_cache(r_cfg, 1, 8, jnp.bfloat16,
                            enc_memory_len=min(enc, 8))[1]
    specs = M.cache_specs(cfg)
    assert _leaves(specs) == _leaves(r_specs)
    ref, port = _policies(cfg.total_params >= FSDP_PARAM_THRESHOLD)
    for (path, spec), (_, shaped) in zip(_leaves(specs), _leaves(shapes)):
        assert port.resolve_spec(shaped.shape, spec) == tuple(
            ref.resolve_spec(shaped.shape, spec)), path
    port_cache = M.init_cache(cfg, 128, 32768, torch.bfloat16, "meta",
                              enc_memory_len=enc)
    assert [tuple(x.shape) for _, x in _leaves(port_cache)] == [
        tuple(x.shape) for _, x in _leaves(shapes)]


def test_shard_is_identity_and_shard_shape():
    x = torch.ones(4, 6)
    with use_policy(ShardingPolicy(mesh=dict(MESH))) as pol:
        assert current_policy() is pol
        assert shard(x, "batch", "ff") is x
    assert current_policy().mesh is None
    assert current_policy().resolve_spec((4, 6), ("batch", None)) == ()
    assert shard_shape((256, 4096, 64), ("data", "model"), MESH) == (16, 256,
                                                                      64)
    assert shard_shape((2, 256, 8), (None, ("data", "model")), MESH) == (2, 1,
                                                                         8)
    from repro_torch.core import device_mesh
    mesh = device_mesh(4, devices="cpu")
    pol = ShardingPolicy(mesh=mesh)
    assert pol.resolve_spec((8, 3), ("batch", None)) == ("data",)


def test_production_mesh_and_policy():
    assert FSDP_PARAM_THRESHOLD == R_THRESHOLD
    assert make_production_mesh() == MESH
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16,
                                                    "model": 16}
    for arch in ARCHITECTURES:
        cfg = get_config(arch)
        pol = make_policy(cfg, make_production_mesh(), rules={"seq": "model"})
        assert pol.enable_fsdp == (cfg.total_params >= 8e9)
        assert pol.rules["seq"] == "model"
