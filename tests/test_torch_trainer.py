"""The port's ``Trainer`` against the reference's, on granite-3-2b
``reduced()`` on the host.

* the reference's ``TestTrainer`` pair on the port: the loss falls over 30
  steps, and a job that crashes after its step-5 commit and is finished by
  a new ``Trainer`` ends on the params of a straight run within 2e-4;
* 5 steps from the same params equal the reference's: losses within 1e-5
  relative, params within 2e-4; and so with ``micro_batches=2`` and with
  ``grad_compression=True``;
* a reference-written step-5 checkpoint resumed by the port's trainer ends
  where the reference's 10-step run does, within 2e-4; a port-written one
  resumes in the reference's trainer the same way;
* ``launch.train.main`` trains 3 steps on the CPU.
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
from repro.train import Trainer as RTrainer
from repro.train import TrainerConfig as RTrainerConfig
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train import Trainer, TrainerConfig

ARCH = "granite-3-2b"
TOL = 2e-4  # the reference's test_restart_resume_exact tolerance


class _Crash(RuntimeError):
    pass


def crash_after(n):
    def on_metrics(step, _):
        if step > n:
            raise _Crash
    return on_metrics


@functools.lru_cache(maxsize=None)
def ref_params():
    params, _ = RM.init_params(jax.random.PRNGKey(3), r_get_config(ARCH).reduced())
    return jax.tree.map(np.asarray, params)


def port_trainer(tcfg, **kw):
    return Trainer(get_config(ARCH).reduced(), TrainerConfig(**tcfg),
                   device="cpu", **kw)


def ref_trainer(tcfg, **kw):
    return RTrainer(r_get_config(ARCH).reduced(), RTrainerConfig(**tcfg), **kw)


def assert_params_close(got_tree, want_tree, tol=TOL):
    got, got_def = jax.tree.flatten(got_tree)
    want, want_def = jax.tree.flatten(jax.tree.map(np.asarray, want_tree))
    assert got_def == want_def
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def test_loss_decreases():
    tr = port_trainer(dict(steps=30, lr=3e-3, warmup=3, log_every=10),
                      global_batch=4, seq_len=32)
    _, _, hist = tr.run()
    first, last = hist[0][1]["loss"], hist[-1][1]["loss"]
    assert [s for s, _ in hist] == [10, 20, 30]
    assert last < first, f"loss did not decrease: {first} -> {last}"


def test_restart_resume_exact(tmp_path):
    tc = dict(steps=10, lr=1e-3, warmup=2, checkpoint_every=5, log_every=1)
    kw = dict(global_batch=2, seq_len=16, seed=1)
    gen = lambda: torch.Generator("cpu").manual_seed(7)  # noqa: E731
    cfg = get_config(ARCH).reduced()
    tr_a = port_trainer(dict(tc, checkpoint_dir=str(tmp_path / "a")), **kw)
    pa, _, _ = tr_a.run(generator=gen())
    tc["checkpoint_dir"] = str(tmp_path / "b")
    tr_b = port_trainer(tc, **kw)
    with pytest.raises(_Crash):
        tr_b.run(generator=gen(), on_metrics=crash_after(5))
    tr_b.ckpt.wait()
    # a NEW trainer resumes the same job and finishes it
    tr_c = port_trainer(tc, **kw)
    pc, state, _ = tr_c.run(generator=gen())
    assert int(state.step) == 10
    assert_params_close(params_to_numpy(cfg, pc), params_to_numpy(cfg, pa))


def twin_runs(steps=5, **tc):
    """The port's and the reference's trainers, 5 steps from the same
    params: (port history, port params, reference history, reference
    params)."""
    tc = dict(steps=steps, lr=3e-3, warmup=2, log_every=1, **tc)
    kw = dict(global_batch=4, seq_len=16, seed=2)
    cfg = get_config(ARCH).reduced()
    lm = params_from_numpy(cfg, ref_params(), "cpu")
    pp, _, hist = port_trainer(tc, **kw).run(params=lm)
    rp, _, r_hist = ref_trainer(tc, **kw).run(
        params=jax.tree.map(jnp.asarray, ref_params()))
    return hist, params_to_numpy(cfg, pp), r_hist, rp


@pytest.mark.parametrize("tc", [{}, {"micro_batches": 2},
                                 {"grad_compression": True}],
                         ids=["plain", "micro_batches", "grad_compression"])
def test_steps_equal_reference_trainer(tc):
    hist, pp, r_hist, rp = twin_runs(**tc)
    assert [s for s, _ in hist] == [s for s, _ in r_hist] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([m["loss"] for _, m in hist],
                               [m["loss"] for _, m in r_hist], rtol=1e-5)
    np.testing.assert_allclose([m["grad_norm"] for _, m in hist],
                               [m["grad_norm"] for _, m in r_hist], rtol=1e-4)
    assert_params_close(pp, rp)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A job that one package's trainer checkpoints at step 5 and crashes
    is finished by the other's; both end where the reference's straight
    10-step run does."""
    tc = dict(steps=10, lr=1e-3, warmup=2, checkpoint_every=5, log_every=1)
    kw = dict(global_batch=2, seq_len=16, seed=1)
    cfg = get_config(ARCH).reduced()
    straight, _, _ = ref_trainer(tc, **kw).run(
        params=jax.tree.map(jnp.asarray, ref_params()))
    tc["checkpoint_dir"] = str(tmp_path)
    first, second = ((ref_trainer, port_trainer) if writer == "reference"
                     else (port_trainer, ref_trainer))
    crashed = first(tc, **kw)
    start = (jax.tree.map(jnp.asarray, ref_params()) if writer == "reference"
             else params_from_numpy(cfg, ref_params(), "cpu"))
    with pytest.raises(_Crash):
        crashed.run(params=start, on_metrics=crash_after(5))
    crashed.ckpt.wait()
    params, state, hist = second(tc, **kw).run()
    assert [s for s, _ in hist] == list(range(6, 11))
    assert int(state.step) == 10
    got = (params_to_numpy(cfg, params) if writer == "reference"
           else jax.tree.map(np.asarray, params))
    assert_params_close(got, straight)


def test_launcher_trains_on_cpu(capsys):
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "3",
                              "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert [s for s, _ in hist] == [3]
    assert np.isfinite(hist[0][1]["loss"])
    assert "loss" in capsys.readouterr().out


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_config(ARCH).reduced(), TrainerConfig(steps=1),
                global_batch=2, seq_len=8)
