"""The port's ``ServeEngine`` against the reference's, on reduced configs
of both served families with the reference's params carried across.

* the same ``(rid, tokens)`` list, in the same order, for the requests of
  ``tests/test_substrate.py::TestServe`` and of ``examples/serve_batch.py``,
  greedy and at temperature 0.8;
* the reference's serving quirks are reproduced (ROADMAP C8): the caches
  equal the reference's after every tick, admission writes the pad token's
  K/V into the other slots' rows at the prompt positions, and a tick writes
  every slot's K/V at the one shared ``pos = max(lengths)``;
* the launcher runs on the CPU when asked to.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import model as RM
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServeEngine as RServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeConfig, ServeEngine

ARCHS = ["granite-3-2b", "rwkv6-7b"]


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    params, _ = RM.init_params(jax.random.PRNGKey(0), r_get_config(arch).reduced())
    return params


def substrate_requests(vocab):
    """tests/test_substrate.py: three requests on two slots."""
    return (dict(max_batch=2, max_len=64, eos_token=-1),
            [(np.array([1, 2, 3]), 4), (np.array([4, 5]), 4), (np.array([6]), 3)])


def example_requests(vocab):
    """examples/serve_batch.py: eight requests on four slots."""
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(8):
        prompt = rng.integers(0, vocab, size=int(rng.integers(2, 10)))
        reqs.append((prompt, int(rng.integers(4, 12))))
    return dict(max_batch=4, max_len=96, eos_token=-1), reqs


def engines(arch, scfg_kw, temperature=0.0):
    r_cfg = r_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    ref = RServeEngine(ref_params(arch), r_cfg,
                       RServeConfig(temperature=temperature, **scfg_kw))
    port = ServeEngine(params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                           ref_params(arch)), "cpu"),
                       cfg, ServeConfig(temperature=temperature, **scfg_kw))
    return ref, port


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("workload", [substrate_requests, example_requests])
@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_equal_reference(arch, workload, temperature):
    scfg_kw, reqs = workload(r_get_config(arch).reduced().vocab)
    ref, port = engines(arch, scfg_kw, temperature)
    for prompt, max_new in reqs:
        assert ref.submit(prompt, max_new) == port.submit(prompt, max_new)
    want = ref.run_to_completion()
    got = port.run_to_completion()
    assert [(rid, list(t)) for rid, t in got] == [(rid, list(t)) for rid, t in want]
    assert {rid for rid, _ in got} == set(range(1, len(reqs) + 1))


def layer0_kv(params, cfg, token: int, pos: int):
    """Layer 0's K and V of ``token`` at position ``pos``: (Hkv, hd) each."""
    layer = params.layers[0]
    h = L.rms_norm(params.embed[torch.tensor([[token]])], layer.norm1, cfg.norm_eps)
    k = torch.einsum("bsd,dhk->bhsk", h, layer.attn.wk)
    v = torch.einsum("bsd,dhk->bhsk", h, layer.attn.wv)
    return L.rope(k, torch.tensor([pos]), cfg.rope_theta)[0, :, 0], v[0, :, 0]


def test_serving_quirks_match_reference():
    """ROADMAP C8, on the substrate requests (slots 0 and 1)."""
    arch = "granite-3-2b"
    scfg_kw, reqs = substrate_requests(None)
    ref, port = engines(arch, scfg_kw)
    for prompt, max_new in reqs:
        ref.submit(prompt, max_new)
        port.submit(prompt, max_new)
    for _ in range(8):
        want, got = ref.tick(), port.tick()
        assert [(r, list(t)) for r, t in got] == [(r, list(t)) for r, t in want]
        flat = jax.tree.leaves(jax.tree.map(np.asarray, ref.cache))
        for w, g in zip(flat, jax.tree.leaves(port.cache)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(port.lengths, ref.lengths)
        if not ref.queue and all(a is None for a in ref.active):
            break

    # the first tick: request 1 ([1, 2, 3]) fed 1, 2 at positions 0, 1 into
    # slot 0, then request 2 ([4, 5]) fed 4 at position 0 into slot 1, which
    # also wrote the pad token 0 into slot 0's position 0; the tick then
    # decoded 3 (slot 0) and 5 (slot 1) both at pos = max(2, 1) = 2
    cfg = port.cfg
    fresh = engines(arch, scfg_kw)[1]
    for prompt, max_new in reqs:
        fresh.submit(prompt, max_new)
    fresh.tick()
    k, v = (fresh.cache["layers"]["attn"][n][0] for n in ("k", "v"))
    for slot, pos, token in ((0, 0, 0), (0, 1, 2), (1, 0, 4), (1, 1, 0),
                             (0, 2, 3), (1, 2, 5)):
        want_k, want_v = layer0_kv(fresh.params, cfg, token, pos)
        torch.testing.assert_close(k[slot, :, pos], want_k, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(v[slot, :, pos], want_v, rtol=1e-5, atol=1e-5)
    assert fresh.lengths.tolist() == [3, 2]


def test_launcher_runs_on_cpu():
    done = launch_serve.main(["--arch", "rwkv6-7b", "--reduced", "--requests",
                              "3", "--max-new", "4", "--device", "cpu"])
    assert sorted(rid for rid, _ in done) == [1, 2, 3]
    assert all(len(t) == 4 for _, t in done)
