"""Cross-chain pooled adaptation and chain sharding over the model zoo and
every adaptive metric: a pooled metric is the same on every chain, and a
run sharded over the 8-device CPU mesh draws what the unsharded run draws."""

import numpy as np
import pytest

import littlemcmc_tpu as lmc
from tests.test_tree_properties import MODELS

METRIC_FIELDS = {"diag": ("var",), "full": ("cov", "chol"),
                 "lowrank": ("var", "vecs", "lam")}


def _kwargs(model_id, metric, **extra):
    model = MODELS[model_id]()
    return dict(logp_dlogp_func=model.logp_grad, model_ndim=model.ndim, chains=8,
                init=f"jitter+adapt_{metric}", random_seed=11, progressbar=False,
                compute_convergence_checks=False, max_treedepth=5, **extra)


@pytest.mark.parametrize("model_id", list(MODELS))
@pytest.mark.parametrize("metric", list(METRIC_FIELDS))
def test_pooled_metric_identical_on_every_chain(model_id, metric):
    trace, _, final = lmc.sample(tune=40, draws=10, cross_chain_adapt=True,
                                 return_final_state=True,
                                 **_kwargs(model_id, metric))
    assert np.isfinite(trace).all()
    for field in METRIC_FIELDS[metric]:
        x = np.asarray(getattr(final.potential, field))
        np.testing.assert_array_equal(x, np.broadcast_to(x[:1], x.shape))


@pytest.mark.parametrize("model_id", list(MODELS))
@pytest.mark.parametrize("metric", list(METRIC_FIELDS))
def test_sharded_equals_unsharded(eight_device_mesh, model_id, metric):
    """Per-chain arithmetic on a one-chain shard may round differently
    from the whole batch, and rounding differences grow along a chain, so
    the comparison covers the first four transitions: the same trees, and
    positions equal up to rounding."""
    kw = _kwargs(model_id, metric, tune=2, draws=2, discard_tuned_samples=False)
    t_plain, s_plain = lmc.sample(**kw)
    t_shard, s_shard = lmc.sample(mesh=eight_device_mesh, **kw)
    np.testing.assert_array_equal(s_plain["depth"], s_shard["depth"])
    np.testing.assert_array_equal(s_plain["diverging"], s_shard["diverging"])
    np.testing.assert_allclose(t_plain, t_shard, rtol=1e-3, atol=1e-2)
