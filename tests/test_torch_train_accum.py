"""PyTorch port's `PaDTTrainer` vs the JAX trainer with gradient
accumulation and with the frozen tower's feature cache, two steps each, on
the fixture and tolerances of tests/test_torch_train_trainer.py (metrics
1e-5 relative; parameters within lr / 10, since Adam moves an element whose
gradient is rounding noise by up to lr either way)."""

from test_torch_train_trainer import _runs, _same_run, setup  # noqa: F401  (setup is the shared fixture)


def test_trainer_grad_accum_matches_jax(setup):
    jt, tt, jlog, tlog = _runs(setup, "ga", per_device_train_batch_size=1, gradient_accumulation_steps=2)
    _same_run(jt, tt, jlog, tlog)


def test_trainer_vision_cache_matches_jax(setup):
    """Frozen tower with cache_vision_features: every sample cached in the
    first epoch, the tower moved to the host, and the same steps as JAX."""
    jt, tt, jlog, tlog = _runs(setup, "cache", freeze_vision_modules=True, cache_vision_features=True)
    assert len(tt._vis_cache) == 4 and tt._tower_dev is None and tt._tower_host is not None
    jt.params = dict(jt.params, vision=jt._tower_host)
    tt.params = tt._full_params()
    _same_run(jt, tt, jlog, tlog, frozen=True)
