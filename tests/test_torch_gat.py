"""GAT in the port (``models/gat.py``, ``ops/gat_attention.py``) against
the plain edge-list reference (``models/gat_reference.py``) on the CPU:
the aggregation's plain version and its three gradients, the whole model's
logits and every parameter's gradient in float32 and bf16 (a model with
uniform attention or without the self slot fails the same tolerances),
one ``Trainer`` epoch at three deduplicated hops with its ``attn_slots``
counter, the command line's config and the config's JSON."""

from __future__ import annotations

import json
from unittest import mock

import numpy as np
import pytest
import torch

from legion_tpu import config as jax_config
from legion_tpu_torch.config import (Config, DatasetConfig, ModelConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data.synthetic import random_power_law_graph
from legion_tpu_torch.models import build_model, gat_reference
from legion_tpu_torch.ops import gat_attention as ga
from legion_tpu_torch.sampling.block import Block, frontier_caps
from legion_tpu_torch.sampling.sampler import (DeviceGraph, gather_features,
                                               sample_batch)
from legion_tpu_torch.train.loop import Trainer, masked_softmax_ce
from legion_tpu_torch.utils import trace

torch.set_num_threads(2)

HEADS, WIDTH, CLASSES, FANOUTS, BATCH = 2, 8, 5, (3, 3, 2), 24
# The port against the float32 reference: the relative gap of the valid
# logits, and the largest gap of a parameter's gradient over the larger of
# its norm and the median parameter's. Over 8 seeds (graphs of 600 nodes,
# 21 seeds a batch):
# float32 read at most 1.7e-7 (logits) and 5.3e-7 (gradients); bf16
# products at most 7.7e-3 and 8.2e-2 (1.4e-2 but one seed, whose layer-1
# att_dst gradient is a sum that cancels); a model with uniform attention
# or without its self slot at least 0.25 and 0.55, in either dtype.
BF16_TOL = {"logits": 3e-2, "grads": 0.2}
F32_TOL = {"logits": 1e-5, "grads": 1e-5}


# -- the aggregation ----------------------------------------------------------

def _attention_case(seed=0, s=40, dn=14, f=5, h=3, c=6):
    """Random scores and slots: row 0 keeps only its self slot, row 1 has
    a slot on its own position, rows past ``num_dst`` hold none."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn((s, h, c), generator=gen)
    a_src = torch.randn((s, h), generator=gen)
    a_dst = torch.randn((dn, h), generator=gen)
    pos = torch.randint(0, s, (dn, f), generator=gen, dtype=torch.int32)
    mask = torch.rand((dn, f), generator=gen) < 0.7
    pos[1, 2], mask[1, 2] = 1, True
    mask[0] = False
    num_dst = dn - 3
    mask[num_dst:] = False
    return z, a_src, a_dst, pos, mask, num_dst


def _edge_list_attention(z, a_src, a_dst, pos, mask, num_dst):
    """The reference's edge-list attention over the live dst rows."""
    src, dst = gat_reference.blocks_to_edges(pos[:num_dst], mask[:num_dst])
    src, dst = gat_reference.self_loops(src, dst, num_dst)
    e = torch.nn.functional.leaky_relu(a_src[src] + a_dst[dst], 0.2)
    alpha = gat_reference.scatter_softmax(e, dst, num_dst)
    return torch.zeros((num_dst,) + z.shape[1:]).index_add(
        0, dst, alpha[..., None] * z[src])


@pytest.mark.parametrize("seed", range(3))
def test_plain_aggregation_matches_the_edge_list_reference(seed):
    z, a_src, a_dst, pos, mask, nd = _attention_case(seed)
    g = torch.randn((pos.shape[0],) + z.shape[1:],
                    generator=torch.Generator().manual_seed(seed + 10))
    got_in = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    want_in = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    got = ga.edge_softmax_aggregate(*got_in, pos, mask,
                                    torch.tensor(nd, dtype=torch.int32))
    want = _edge_list_attention(*want_in, pos, mask, nd)
    torch.testing.assert_close(got[:nd], want, rtol=1e-5, atol=1e-6)
    assert (got[nd:] == 0).all()
    # the row with only its self slot is its own z row
    torch.testing.assert_close(got[0], z[0])
    (got * g).sum().backward()
    (want * g[:nd]).sum().backward()
    for a, b in zip(got_in, want_in):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def test_scored_slots_counts_the_self_slots():
    z, a_src, a_dst, pos, mask, nd = _attention_case(1)
    n = int(ga.scored_slots(pos, mask, z.shape[0],
                            torch.tensor(nd, dtype=torch.int32)))
    d = torch.arange(pos.shape[0])[:, None]
    want = int((mask & (pos != d)).sum()) + nd
    assert n == want


def test_aggregation_refuses_mixed_dtypes():
    z, a_src, a_dst, pos, mask, _ = _attention_case()
    with pytest.raises(ValueError, match="one dtype"):
        ga.edge_softmax_aggregate(z.bfloat16(), a_src, a_dst, pos, mask)


# -- the model ----------------------------------------------------------------

def _batch(seed=0, n=600):
    g = random_power_law_graph(num_nodes=n, avg_degree=6, feature_dim=12,
                               num_classes=CLASSES, seed=seed)
    graph = DeviceGraph.from_host(g.indptr, g.indices, torch.device("cpu"))
    seeds = torch.full((BATCH,), -1, dtype=torch.int32)
    ids = np.random.default_rng(seed).permutation(g.train_ids)[:BATCH - 3]
    seeds[:len(ids)] = torch.from_numpy(ids.astype(np.int32))
    labels = torch.zeros(BATCH, dtype=torch.int32)
    labels[:len(ids)] = torch.from_numpy(g.labels[ids].astype(np.int32))
    b = sample_batch(graph, seeds, torch.tensor(len(ids), dtype=torch.int32),
                     labels, FANOUTS, frontier_caps(BATCH, FANOUTS),
                     dedup_last=True,
                     generator=torch.Generator().manual_seed(seed))
    feats = torch.from_numpy(np.asarray(g.features, np.float32))
    return b, gather_features(feats, b.frontier), len(ids)


def _gaps(model, seed):
    """Relative gaps of the port's logits and gradients against the
    reference's, on one batch with the model's own weights."""
    b, x, num = _batch(seed)
    out = model(tuple(reversed(b.blocks)), x)
    mask = torch.arange(BATCH) < num
    masked_softmax_ce(out, b.labels, mask).backward()
    w = {k: p.detach().clone().requires_grad_(True)
         for k, p in model.named_parameters()}
    blocks = [(k.nbr_pos, k.nbr_mask) for k in reversed(b.blocks)]
    ref = gat_reference.logits(w, x, blocks, HEADS)
    gat_reference.loss(ref, b.labels, num).backward()
    rel = float((out[:num].detach().float() - ref[:num].detach()).norm()
                / ref[:num].detach().norm())
    # each leaf's gap over the larger of its norm and the median leaf's,
    # as the benchmark's check weighs them: an attention vector's gradient
    # is a sum of terms that cancel (a softmax's gradients sum to zero over
    # a row), so bf16 scores leave it a large share of its own small norm
    norms = {k: float(v.grad.norm()) for k, v in w.items()}
    med = float(np.median(list(norms.values())))
    grads = max(float((p.grad - w[k].grad).norm()) / max(norms[k], med)
                for k, p in model.named_parameters())
    return {"logits": rel, "grads": grads}


def _model(seed, dtype=torch.float32):
    return build_model("gat", 12, WIDTH, CLASSES, len(FANOUTS), 0.0,
                       dtype=dtype, num_heads=HEADS,
                       generator=torch.Generator().manual_seed(seed))


def test_reference_names_the_model_parameters():
    assert sorted(gat_reference.parameter_names(3)) == sorted(
        k for k, _ in _model(0).named_parameters())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(2))
def test_model_matches_the_reference(dtype, tol, seed):
    gaps = _gaps(_model(seed, dtype), seed)
    assert gaps["logits"] < tol["logits"] and gaps["grads"] < tol["grads"], \
        gaps


def _uniform():
    """Every score zero: the attention a plain mean over the slots."""
    fn = ga.edge_softmax_aggregate_plain

    def uniform(z, a_src, a_dst, *rest):
        return fn(z, a_src * 0, a_dst * 0, *rest)
    return mock.patch.object(ga, "edge_softmax_aggregate_plain", uniform)


def _no_self_slot():
    """No row scores its self slot."""
    fn = ga.scored

    def no_self(*args):
        ok = fn(*args)
        ok[:, -1] = False
        return ok
    return mock.patch.object(ga, "scored", no_self)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("fault", ["uniform_attention", "no_self_slot"])
def test_a_broken_attention_fails_the_tolerances(fault, dtype, tol):
    plant = {"uniform_attention": _uniform,
             "no_self_slot": _no_self_slot}[fault]
    with plant():
        gaps = _gaps(_model(0, dtype), 0)
    assert gaps["logits"] > tol["logits"] or gaps["grads"] > tol["grads"], \
        gaps


def test_an_identity_block_is_refused():
    model = _model(0)
    blk = Block(nbr_pos=torch.zeros((4, 2), dtype=torch.int32),
                nbr_mask=torch.ones((4, 2), dtype=torch.bool),
                num_src=torch.tensor(12, dtype=torch.int32),
                num_dst=torch.tensor(4, dtype=torch.int32),
                identity_offset=4)
    with pytest.raises(ValueError, match="dedup_last"):
        model.layers[0](blk, torch.zeros((12, 12)))


def test_heads_belong_to_gat_alone():
    with pytest.raises(ValueError, match="num_heads"):
        build_model("sage", 12, 8, 3, 2, 0.0, num_heads=2)


# -- the trainer and the config -----------------------------------------------

def _cfg(**model):
    return Config(
        dataset=DatasetConfig(num_classes=CLASSES),
        sampler=SamplerConfig(fanouts=FANOUTS, batch_size=64,
                              eval_batch_size=64, dedup_last=True),
        model=ModelConfig(arch="gat", hidden_dim=WIDTH, num_layers=3,
                          dropout=0.5, num_heads=HEADS, **model),
        train=TrainConfig(epochs=1, seed=3))


def test_trainer_epoch_at_three_deduplicated_hops():
    g = random_power_law_graph(num_nodes=1500, avg_degree=6, feature_dim=12,
                               num_classes=CLASSES, seed=4)
    tr = Trainer(_cfg(dtype="bfloat16"), g, device="cpu")
    rec = tr.train_one_epoch(0)
    assert np.isfinite(rec["losses"]).all()
    assert rec["cap_overflow"] == 0
    assert 0 < rec["counts"]["attn_slots"]
    # every step scores at most its batch's slots and self slots, hop by hop
    caps = tr.caps
    most = sum(caps[k] * (f + 1) for k, f in enumerate(FANOUTS))
    assert rec["counts"]["attn_slots"] <= rec["steps"] * most
    assert trace.epochs("train")[-1]["counts"]["attn_slots"] == \
        rec["counts"]["attn_slots"]


def test_a_model_without_step_counts_counts_no_attention():
    """The step's ``attn_slots`` column is the model's own count: 0 from a
    model with no ``step_counts`` (SAGE), and no counter in its epoch."""
    g = random_power_law_graph(num_nodes=1500, avg_degree=6, feature_dim=12,
                               num_classes=CLASSES, seed=4)
    cfg = Config(dataset=DatasetConfig(num_classes=CLASSES),
                 sampler=SamplerConfig(fanouts=(3, 2), batch_size=64),
                 model=ModelConfig(arch="sage", hidden_dim=WIDTH,
                                   num_layers=2),
                 train=TrainConfig(epochs=1, seed=3))
    tr = Trainer(cfg, g, device="cpu")
    assert not hasattr(tr.model, "step_counts")
    seeds = np.asarray(g.train_ids[:128], np.int32).reshape(2, 64)
    metrics = tr._train_steps(seeds, None).cpu()
    assert metrics[:, -1].tolist() == [0.0, 0.0]
    rec = tr.train_one_epoch(0)
    assert "attn_slots" not in rec["counts"]


def test_gat_config_round_trips_and_the_reference_refuses_it():
    cfg = _cfg()
    assert Config.from_json(cfg.to_json()) == cfg
    assert json.loads(cfg.to_json())["model"]["num_heads"] == HEADS
    assert "num_heads" not in json.loads(Config().to_json())["model"]
    with pytest.raises(ValueError, match="num_heads"):
        jax_config.Config.from_json(cfg.to_json())
