"""The port's training stack (tagan_torch.train, tagan_torch.data, dropout)
against the JAX package's on the CPU: trainer steps from the same
converted parameters and batches, the loader's batches, the metrics,
the schedules, checkpoints and dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_tpu.data.dataset import TemporalGraphDataLoader as JLoader
from tagan_tpu.data.dataset import TemporalGraphDataset as JDataset
from tagan_tpu.data.synthetic import (create_dynamic_synthetic_data,
                                      create_synthetic_data)
from tagan_tpu.nn.model import TAGAN as JTAGAN
from tagan_tpu.train import metrics as JM
from tagan_tpu.train.trainer import TAGANTrainer as JTrainer
from tagan_torch.convert import params_from_jax
from tagan_torch.core.module import dropout
from tagan_torch.train import metrics as TM
from tagan_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tagan_torch.train.trainer import make_schedule

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order
TOL = 1e-4

CFG = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=8,
           output_dim=1, loss_type="bce", dropout=0.0, flash_block_m=16,
           flash_block_n=16, learning_rate=1e-2, weight_decay=0.05,
           gradient_clip_val=0.1)


# gradients that are zero in exact arithmetic: the temporal attention's
# key and time-query biases add one constant to every score of a row
ZERO_GRAD = ("temporal_attention.k.b",
             "temporal_attention.time_encoding.basis_proj.b",
             "temporal_attention.time_q_proj.b")


def _data(n=5, seed=3):
    return create_synthetic_data(num_samples=n, num_nodes_range=(6, 12),
                                 node_feature_dim=8, edge_feature_dim=0,
                                 sequence_length=3, seed=seed)


def _torch_model(jp, **kw):
    tm = pt.TAGAN(pt.TAGANConfig(**{**CFG, **kw}), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp)))
    return tm


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _trainer_steps_match(data, noise=(), **cfg):
    """3 steps (the last batch padded) of both trainers from the same
    parameters and batches; the losses, predictions and parameters after
    every step agree. Parameters named in ``noise`` have a gradient that
    is zero in exact arithmetic (a bias that adds one constant to every
    score of a softmax row): fp32 noise of either sign, which Adam turns
    into steps of up to the learning rate, so they are only required to
    stay finite."""
    exp = dict(batch_size=2, num_epochs=2, lr_scheduler="cosine", seed=0)
    jm = JTAGAN(tt.TAGANConfig(**{**CFG, **cfg}))
    jp = jm.init(jax.random.key(0))
    jt = JTrainer(jm, tt.ExperimentConfig(model=jm.config, **exp), params=jp)
    tm = _torch_model(jp, **cfg)
    tr = pt.TAGANTrainer(tm, pt.ExperimentConfig(model=tm.config, **exp))
    jl = JLoader(JDataset(data), batch_size=2, shuffle=True, seed=4)
    tl = pt.TemporalGraphDataLoader(pt.TemporalGraphDataset(data),
                                    batch_size=2, shuffle=True, seed=4)
    steps = 0
    for (jb, jy, jmask), (tb, ty, tmask) in zip(jl, tl):
        jt.rng, r = jax.random.split(jt.rng)
        jt.params, jt.opt_state, jloss, jpred = jt._train_step(
            jt.params, jt.opt_state, jb, jy, jmask, r, jnp.asarray(1.0))
        tloss, tpred = tr._train_step(tb, ty, tmask)
        steps += 1
        assert abs(tloss.item() - float(jloss)) <= TOL
        np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                                   rtol=TOL, atol=TOL)
        want = _flat(jt.params)
        for name, param in tm.named_parameters():
            if name in noise:
                assert torch.isfinite(param).all(), name
                continue
            np.testing.assert_allclose(param.detach().numpy(), want[name],
                                       rtol=TOL, atol=TOL, err_msg=name)
    assert steps == 3 and tr.global_step == 3 and tr.optimizer.count == 3
    return tm


def test_trainer_steps_match_jax():
    """3 steps (the last batch padded) of both trainers from the same
    parameters and batches: global-norm clipping that triggers, AdamW
    with weight decay on the cosine schedule, dropout 0. The losses and
    the parameters after every step agree."""
    _trainer_steps_match(_data())


def test_flash_edge_trainer_steps_match_jax():
    """The same 3 steps for the edge-feature model on the flash backend
    (the biased backward's plain version against the Pallas kernels in
    interpret mode): the edge embedding and both layers' edge bias are
    held against the JAX trainer's after every step."""
    data = create_synthetic_data(num_samples=5, num_nodes_range=(6, 12),
                                 node_feature_dim=8, edge_feature_dim=4,
                                 sequence_length=3, seed=6)
    tm = _trainer_steps_match(data, ZERO_GRAD, edge_feature_dim=4,
                              use_edge_features=True,
                              spatial_backend="flash")
    assert {"edge_embedding.w", "geometric_layers.layer_0.edge_bias.w",
            "geometric_layers.layer_1.edge_bias.w"} <= \
        dict(tm.named_parameters()).keys()


@pytest.mark.parametrize("sched", [None, "cosine", "step"])
def test_schedules_match_optax(sched):
    cfg = pt.TAGANConfig(learning_rate=3e-3)
    exp = pt.ExperimentConfig(model=cfg, num_epochs=3, lr_scheduler=sched,
                              lr_scheduler_step_size=1,
                              lr_scheduler_factor=0.5)
    want = {None: lambda s: 3e-3,
            "cosine": optax.cosine_decay_schedule(3e-3, 3 * 100),
            "step": optax.exponential_decay(3e-3, 100, 0.5,
                                            staircase=True)}[sched]
    got = make_schedule(cfg, exp)
    # optax evaluates in float32: 1e-6 of the base rate
    for step in (0, 1, 99, 100, 150, 299, 300, 450):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=3e-9)


@pytest.mark.parametrize("shuffle,buckets,drop,workers", [
    (False, 1, False, 0), (True, 1, False, 2), (True, 2, False, 0),
    (True, 2, True, 0)])
def test_loader_matches_jax(shuffle, buckets, drop, workers):
    """Two epochs of batches, labels and sample masks, field for field."""
    data = create_dynamic_synthetic_data(num_samples=7, sequence_length=3,
                                         num_nodes_range=(5, 15),
                                         node_feature_dim=4, seed=5)
    kw = dict(batch_size=3, shuffle=shuffle, seed=11, num_buckets=buckets,
              drop_remainder=drop, num_workers=workers)
    jl = JLoader(JDataset(data), **kw)
    tl = pt.TemporalGraphDataLoader(pt.TemporalGraphDataset(data), **kw)
    assert len(tl) == len(jl)
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        for (tb, ty, tmask), (jb, jy, jmask) in zip(got, want):
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
            assert ty.numpy().dtype == np.asarray(jy).dtype
            np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
            for f in ("x", "node_mask", "adj", "edge_src", "edge_dst",
                      "edge_mask", "times", "time_mask", "node_ids"):
                np.testing.assert_array_equal(
                    getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                    err_msg=f)


def test_dataset_split_kfold_and_unported_options():
    data = _data(n=8)
    jd, td = JDataset(data), pt.TemporalGraphDataset(data)
    assert td.get_statistics() == jd.get_statistics()
    for a, b in zip(td.split(seed=1), jd.split(seed=1)):
        assert a.labels == b.labels
    for (ta, va), (tb, vb) in zip(td.kfold(4, seed=2), jd.kfold(4, seed=2)):
        assert ta.labels == tb.labels and va.labels == vb.labels
    with pytest.raises(NotImplementedError):
        pt.TemporalGraphDataLoader(td, plan="ring")
    assert pt.TemporalGraphDataLoader(td, plan="hybrid").plan == "hybrid"
    # the slot reordering is ported: it packs what JAX's loader packs
    for (tb, _, _), (jb, _, _) in zip(
            pt.TemporalGraphDataLoader(td, batch_size=4, reorder="rcm"),
            JLoader(jd, batch_size=4, reorder="rcm")):
        np.testing.assert_array_equal(tb.node_ids.numpy(),
                                      np.asarray(jb.node_ids))
        np.testing.assert_array_equal(tb.x.numpy(), np.asarray(jb.x))


@pytest.mark.parametrize("multi", [False, True])
def test_calculate_metrics_matches_jax(multi):
    rng = np.random.default_rng(6)
    if multi:
        preds = rng.dirichlet(np.ones(3), size=40)
        labels = rng.integers(0, 3, 40)
    else:
        preds = rng.random(40)
        labels = rng.integers(0, 2, 40)
    assert TM.calculate_metrics(preds, labels) == \
        JM.calculate_metrics(preds, labels)
    tracker = TM.MetricsTracker()
    tracker.update("val", {"f1": 0.5})
    tracker.update("val", {"f1": 0.7})
    assert tracker.best_epoch("val") == 1 and tracker.best()["f1"] == 0.7


def test_checkpoint_round_trip(tmp_path):
    """A checkpoint holds the parameters and the optimizer state: a new
    trainer that loads it takes the same next step as the one that
    saved it."""
    data = _data(n=4, seed=7)
    cfg = pt.TAGANConfig(**CFG)
    loader = pt.TemporalGraphDataLoader(pt.TemporalGraphDataset(data),
                                        batch_size=2)
    (b0, y0, m0), (b1, y1, m1) = list(loader)
    tr = pt.TAGANTrainer(pt.TAGAN(cfg, device="cpu"),
                         pt.ExperimentConfig(model=cfg, seed=1))
    tr._train_step(b0, y0, m0)
    path = str(tmp_path / "ck" / "model.ckpt")
    tr.save_checkpoint(path, metrics={"f1": 0.25})
    other = pt.TAGANTrainer(
        pt.TAGAN(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(9)),
        pt.ExperimentConfig(model=cfg, seed=1))
    assert other.load_checkpoint(path) == {"f1": 0.25}
    assert other.global_step == 1 and other.optimizer.count == 1
    l_a, _ = tr._train_step(b1, y1, m1)
    l_b, _ = other._train_step(b1, y1, m1)
    assert l_a.item() == l_b.item()
    for (n, a), (_, b) in zip(tr.model.named_parameters(),
                              other.model.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    payload = load_checkpoint(path)
    assert pt.TAGANConfig.from_dict(payload["config"]) == cfg
    assert pt.ExperimentConfig.from_dict(payload["experiment"]) \
        == tr.experiment
    with pytest.raises(NotImplementedError):
        save_checkpoint(path, {}, backend="orbax")


def test_dropout_rate_scaling_and_generator():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.3, g)
    kept = y != 0
    assert abs(1.0 - kept.float().mean().item() - 0.3) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    again = dropout(x, 0.3, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, y, rtol=0, atol=0)
    assert dropout(x, 0.3, None) is x and dropout(x, 0.0, g) is x


@pytest.mark.parametrize("backend", ["dense", "flash"])
def test_training_forward_drops_only_with_a_generator(backend):
    """Serving is deterministic even though a new module is in training
    mode; the training forward drops (flash: attention dropout in the
    kernel's plain version, from per-snapshot seeds) and is reproducible
    from the generator's seed, with finite gradients."""
    data = _data(n=2, seed=8)
    cfg = pt.TAGANConfig(**{**CFG, "dropout": 0.3,
                            "spatial_backend": backend})
    model = pt.TAGAN(cfg, device="cpu")
    batch, labels, _ = next(iter(pt.TemporalGraphDataLoader(
        pt.TemporalGraphDataset(data), batch_size=2,
        dense_adj=backend == "dense")))
    assert model.training
    with torch.no_grad():
        a, b = model(batch).logits, model(batch).logits
        c = model(batch, deterministic=True,
                  generator=torch.Generator().manual_seed(1)).logits
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    outs = []
    for _ in range(2):
        model.zero_grad()
        out = model(batch, labels, deterministic=False,
                    generator=torch.Generator().manual_seed(2))
        out.loss.backward()
        outs.append((out.logits.detach(),
                     [p.grad.clone() for p in model.parameters()]))
    assert not torch.allclose(outs[0][0], a)
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for g0, g1 in zip(outs[0][1], outs[1][1]):
        assert torch.isfinite(g0).all()
        torch.testing.assert_close(g0, g1, rtol=0, atol=0)


def test_train_loop_cross_validate_and_predict(tmp_path):
    """train() with a validation loader keeps the best checkpoint and
    stops early; cross_validate gives one result per fold; predict
    returns the real sequences' probabilities."""
    data = _data(n=6, seed=9)
    cfg = pt.TAGANConfig(**{**CFG, "dropout": 0.1})
    exp = pt.ExperimentConfig(model=cfg, batch_size=4, num_epochs=3,
                              early_stopping_patience=1, seed=3,
                              lr_scheduler="plateau",
                              lr_scheduler_patience=1, num_folds=2)
    ds = pt.TemporalGraphDataset(data)
    train_ds, val_ds, _ = ds.split((0.5, 0.5, 0.0), seed=0)
    tr = pt.TAGANTrainer(pt.TAGAN(cfg, device="cpu"), exp)
    res = tr.train(pt.TemporalGraphDataLoader(train_ds, batch_size=4),
                   pt.TemporalGraphDataLoader(val_ds, batch_size=2),
                   checkpoint_dir=str(tmp_path), verbose=False)
    assert 1 <= len(res["history"]["train_loss"]) <= 3
    assert all(np.isfinite(res["history"]["train_loss"]))
    assert (tmp_path / "best_model.ckpt").exists()
    probs = tr.predict(pt.TemporalGraphDataLoader(ds, batch_size=4))
    assert probs.shape == (6, 1) and np.isfinite(probs).all()
    cv = pt.cross_validate(pt.TAGAN(cfg, device="cpu"), ds, exp,
                           num_epochs=1)
    assert len(cv["folds"]) == 2 and "f1" in cv["mean"]
    with pytest.raises(NotImplementedError):
        pt.TAGANTrainer(pt.TAGAN(cfg, device="cpu"),
                        exp.replace(plot_history=True)).train(
            pt.TemporalGraphDataLoader(train_ds))
