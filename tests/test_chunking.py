"""Chunked execution over the model zoo and every adaptive metric: the
draws do not depend on how the run is cut into compiled chunks, and an
interrupted run resumes from its checkpoint to the uninterrupted draws."""

import numpy as np
import pytest

import littlemcmc_tpu as lmc
from littlemcmc_tpu.utils.checkpoint import latest_checkpoint
from tests.test_tree_properties import MODELS

METRICS = ("diag", "full", "lowrank")


def _kwargs(model_id, metric, sampler="nuts"):
    model = MODELS[model_id]()
    step = (lmc.NUTS(model_ndim=model.ndim, max_treedepth=5) if sampler == "nuts"
            else lmc.HamiltonianMC(model_ndim=model.ndim, max_steps=32))
    return dict(logp_dlogp_func=model.logp_grad, model_ndim=model.ndim, chains=4,
                tune=30, draws=30, init=f"jitter+adapt_{metric}", step=step,
                random_seed=7, progressbar=False, compute_convergence_checks=False)


@pytest.mark.parametrize("model_id", list(MODELS))
@pytest.mark.parametrize("metric", METRICS)
def test_draws_do_not_change_with_progress_every(model_id, metric):
    kw = _kwargs(model_id, metric)
    t_one, s_one = lmc.sample(**kw)
    t_chunk, s_chunk = lmc.sample(progress_every=20, **kw)
    np.testing.assert_array_equal(t_one, t_chunk)
    np.testing.assert_array_equal(s_one["tree_size"], s_chunk["tree_size"])


@pytest.mark.parametrize("sampler,metric", [
    ("nuts", "diag"), ("nuts", "full"), ("nuts", "lowrank"), ("hmc", "diag")])
def test_chunk_interrupt_and_resume(tmp_path, sampler, metric):
    """KeyboardInterrupt between compiled chunks returns the completed
    chunks and an interrupt checkpoint; resume finishes the run, and the
    two parts together equal an uninterrupted run."""
    ckpt = str(tmp_path / "ckpt")
    kw = _kwargs("corrgauss", metric, sampler)

    def interrupt(iteration, tuning, states, chunk, n_divergences):
        if iteration >= 40:  # tune=30 + one collected 10-draw chunk
            raise KeyboardInterrupt

    t_part, s_part = lmc.sample(progress_every=10, callback=interrupt,
                                checkpoint_dir=ckpt, checkpoint_every=10, **kw)
    assert t_part.shape[:2] == (4, 10)
    assert latest_checkpoint(ckpt).endswith("step_00000040")
    t_rest, _ = lmc.sample(checkpoint_dir=ckpt, resume=True, **kw)
    assert t_rest.shape[:2] == (4, 20)
    t_full, _ = lmc.sample(**kw)
    np.testing.assert_array_equal(np.concatenate([t_part, t_rest], axis=1), t_full)
