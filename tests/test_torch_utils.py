"""The port's utils (config, devcache, diagnostics, checkpoint) held against
the JAX package's copies on the same inputs."""

import dataclasses

import numpy as np
import pytest

from genomicbreedingmodels_tpu.utils import config as config_jax
from genomicbreedingmodels_tpu.utils import devcache as devcache_jax
from genomicbreedingmodels_tpu.utils import diagnostics as diag_jax
from genomicbreedingmodels_tpu_torch.utils import checkpoint, config, devcache, diagnostics


def _ar1(m, t, phi, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((m, t))
    for i in range(1, t):
        x[:, i] = phi * x[:, i - 1] + rng.normal(size=m)
    return x


@pytest.mark.parametrize("m,t,phi", [(1, 400, 0.0), (1, 400, 0.9), (4, 250, 0.5), (2, 3, 0.2)])
def test_diagnostics_equal_jax(m, t, phi):
    x = _ar1(m, t, phi, seed=m * 100 + t)
    assert diagnostics.ess(x) == diag_jax.ess(x)
    r, rj = diagnostics.split_rhat(x), diag_jax.split_rhat(x)
    assert r == rj or (np.isinf(r) and np.isinf(rj))
    assert diagnostics.mcmc_diagnostics(x, name="s") == diag_jax.mcmc_diagnostics(x, name="s")


def test_config_reads_the_same_env(monkeypatch):
    monkeypatch.setenv("GBM_MCMC_BLOCK_SIZE", "96")
    monkeypatch.setenv("GBM_MCMC_INDICATOR_UPDATE", "scalar")
    monkeypatch.setenv("GBM_MCMC_GROUP_SIZE", "4")
    config.reset_config()
    config_jax.reset_config()
    try:
        c, cj = config.get_config(), config_jax.get_config()
        assert dataclasses.asdict(c) == dataclasses.asdict(cj)
        assert (c.mcmc_block_size, c.mcmc_indicator_update, c.mcmc_group_size) == (96, "scalar", 4)
    finally:
        monkeypatch.undo()
        config.reset_config()
        config_jax.reset_config()
    d = config.get_config()
    assert (d.mcmc_n_iter, d.mcmc_n_burnin, d.mcmc_block_size, d.mcmc_group_size,
            d.mcmc_indicator_update) == (1500, 500, 256, 6, "auto")
    assert dataclasses.asdict(d) == dataclasses.asdict(config_jax.GBMConfig())
    config.set_config(config.GBMConfig(mcmc_n_iter=7))
    assert config.get_config().mcmc_n_iter == 7
    config.reset_config()


def test_devcache_fingerprint_and_slots():
    a = np.random.default_rng(0).random((50, 90)).astype(np.float32)
    assert devcache.host_fingerprint(a) == devcache_jax.host_fingerprint(a)
    b = a.copy()
    b[0, 0] += 1.0  # the strided sample includes element 0
    assert devcache.host_fingerprint(b) != devcache.host_fingerprint(a)
    assert devcache.host_fingerprint(np.zeros((0, 3))) == devcache_jax.host_fingerprint(np.zeros((0, 3)))
    c1, c2 = devcache.SingleSlotCache(), devcache.SingleSlotCache()
    assert c1.put(("k",), 1) == 1 and c1.get(("k",)) == 1 and c1.get(("j",)) is None
    c2.put(("k",), 2)
    assert devcache.clear_device_caches() >= 2
    assert c1.get(("k",)) is None and c2.get(("k",)) is None


def test_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "sub" / "state.npz"
    assert checkpoint.load_state(str(path)) is None
    state = {"s0": np.arange(5.0), "s7": np.arange(16, dtype=np.uint8), "__done__": np.asarray(3)}
    checkpoint.save_state(str(path), state)
    back = checkpoint.load_state(str(path))
    assert set(back) == set(state)
    for k in state:
        assert back[k].dtype == state[k].dtype and np.array_equal(back[k], state[k])
    assert [p.name for p in path.parent.iterdir()] == ["state.npz"]  # no temp file left
