"""Checkpoint/resume and chunked-execution tests."""

import numpy as np
import pytest

import littlemcmc_tpu as lmc
from tests.conftest import std_normal_logp_grad


def test_chunked_equals_oneshot(tmp_path):
    kwargs = dict(
        logp_dlogp_func=std_normal_logp_grad,
        model_ndim=2,
        draws=80,
        tune=60,
        chains=2,
        random_seed=9,
        progressbar=False,
    )
    t_one, s_one = lmc.sample(**kwargs)
    t_chunk, s_chunk = lmc.sample(progress_every=25, **kwargs)
    np.testing.assert_array_equal(t_one, t_chunk)
    np.testing.assert_array_equal(s_one["depth"], s_chunk["depth"])


def test_checkpoint_and_resume_bit_identical(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    kwargs = dict(
        logp_dlogp_func=std_normal_logp_grad,
        model_ndim=2,
        draws=60,
        tune=40,
        chains=2,
        random_seed=17,
        progressbar=False,
    )
    # Full run with periodic checkpoints.
    t_full, _ = lmc.sample(checkpoint_dir=ckpt, checkpoint_every=30, **kwargs)

    # Resume from the latest snapshot (step 90 of 100) and re-run the tail.
    from littlemcmc_tpu.utils.checkpoint import latest_checkpoint

    last = latest_checkpoint(ckpt)
    assert last is not None and last.endswith("step_00000090")
    t_resumed, s_resumed = lmc.sample(
        checkpoint_dir=ckpt, resume=True, **kwargs
    )
    # resumed run emits only post-restore draws: iterations 90..100, all
    # in the sampling phase -> 10 draws
    assert t_resumed.shape == (2, 10, 2)
    np.testing.assert_array_equal(t_resumed, t_full[:, -10:, :])


def test_resume_requires_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        lmc.sample(
            logp_dlogp_func=std_normal_logp_grad,
            model_ndim=1,
            draws=10,
            tune=10,
            chains=2,
            resume=True,
            progressbar=False,
        )


def test_checkpoint_roundtrip_pytree(tmp_path):
    """Direct save/restore of a ChainState pytree."""
    import jax
    import jax.numpy as jnp

    from littlemcmc_tpu.base import init_chain_state
    from littlemcmc_tpu.sampling import _make_adaptive_potential
    from littlemcmc_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

    cfg = lmc.NUTSConfig()
    pot = _make_adaptive_potential(3, jnp.zeros(3), False, jnp.float32)
    state = init_chain_state(jax.random.key(0), jnp.ones(3), pot, cfg, std_normal_logp_grad)
    path = save_checkpoint(str(tmp_path / "c"), state, 5, meta={"x": 1})
    restored, meta = restore_checkpoint(path, state)
    assert meta["step"] == 5 and meta["x"] == 1
    np.testing.assert_array_equal(np.asarray(restored.q), np.asarray(state.q))
    np.testing.assert_array_equal(
        np.asarray(restored.potential.var), np.asarray(state.potential.var)
    )


def test_interrupt_returns_partial_trace_and_checkpoints(tmp_path):
    """KeyboardInterrupt mid-run returns completed chunks + a checkpoint.

    The reference returns the draws collected so far on interrupt in its
    sequential path (``sampling.py:463-471``); here an interrupt between
    compiled chunks returns every completed chunk and (when a
    checkpoint_dir is set) snapshots the state so ``resume=True``
    continues bit-identically.
    """
    ckpt = str(tmp_path / "ckpt_int")
    kwargs = dict(
        logp_dlogp_func=std_normal_logp_grad,
        model_ndim=2,
        draws=80,
        tune=40,
        chains=2,
        random_seed=3,
        progressbar=False,
    )

    def interrupting_cb(iteration, tuning, states, chunk, n_divergences):
        if iteration >= 60:  # tune=40 + one collected 20-draw chunk
            raise KeyboardInterrupt

    t_part, s_part = lmc.sample(
        progress_every=20, callback=interrupting_cb,
        checkpoint_dir=ckpt, checkpoint_every=20, **kwargs
    )
    # one 20-draw chunk was completed and collected before the interrupt
    assert t_part.shape == (2, 20, 2)
    assert s_part["depth"].shape == (2, 20)

    from littlemcmc_tpu.utils.checkpoint import latest_checkpoint

    last = latest_checkpoint(ckpt)
    assert last is not None and last.endswith("step_00000060")

    # resuming completes the run; combined draws == an uninterrupted run
    t_rest, _ = lmc.sample(checkpoint_dir=ckpt, resume=True, **kwargs)
    assert t_rest.shape == (2, 60, 2)
    t_full, _ = lmc.sample(**kwargs)
    np.testing.assert_array_equal(
        np.concatenate([t_part, t_rest], axis=1), t_full
    )
