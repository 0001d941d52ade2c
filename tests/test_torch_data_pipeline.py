"""Port of the KG -> token pipeline (``data/pipeline.py``): the same DIS
through both packages' ``mapsdi_create_kg`` and ``linearize_kg`` gives
bit-identical streams; ``batch``, ``shard_batch``, ``rows_for_shard`` and
``rebalance`` equal the reference's; ``random_lm_batch`` is equal for one
numpy generator; and the cases of ``tests/test_data_pipeline.py`` on the
port (its Hypothesis property as a fixed grid). Everything here is exact:
the module is numpy only in both packages.
"""
import numpy as np
import pytest
import torch

import repro.core.pipeline as JP
import repro.data.pipeline as JD
import repro.data.synthetic as JS
import repro_torch.core.pipeline as TP
import repro_torch.data.pipeline as TD
import repro_torch.data.synthetic as TS
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced_config
from repro_torch.configs import get_config, reduced_config
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _stream(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 250, size=n).astype(np.int32) + TD.N_SPECIAL


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,rows,redundancy,seed,vocab", [
    ("group_a", 200, 0.8, 3, 256),
    ("group_a", 400, 0.5, 1, 151936),
    ("group_b", 120, 0.6, 2, 1024),
])
def test_linearized_kg_streams_are_bit_identical(kind, rows, redundancy,
                                                 seed, vocab):
    make = {"group_a": (JS.make_group_a_dis, TS.make_group_a_dis),
            "group_b": (JS.make_group_b_dis, TS.make_group_b_dis)}[kind]
    jkg, jstats = JP.mapsdi_create_kg(make[0](rows, redundancy, seed=seed))
    tkg, tstats = TP.mapsdi_create_kg(make[1](rows, redundancy, seed=seed,
                                              device="cpu"))
    assert jstats["kg_triples"] == tstats["kg_triples"] > 0
    for s in (0, 7):
        want = JD.linearize_kg(jkg, vocab, seed=s)
        got = TD.linearize_kg(tkg, vocab, seed=s)
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()


def test_empty_kg_linearizes_like_the_reference():
    jkg, _ = JP.mapsdi_create_kg(JS.make_group_a_dis(8, 0.5, seed=0))
    tkg, _ = TP.mapsdi_create_kg(TS.make_group_a_dis(8, 0.5, seed=0,
                                                     device="cpu"))
    assert np.array_equal(TD.linearize_kg(tkg, 256),
                          JD.linearize_kg(jkg, 256))
    empty = type(tkg).from_codes(np.zeros((0, 5), np.int32), tkg.attrs,
                                 device="cpu")
    assert TD.linearize_kg(empty, 256).tolist() == [TD.BOT, TD.EOT]


@pytest.mark.parametrize("seq_len,global_batch,steps", [
    (32, 8, (0, 1, 17)), (16, 4, (3, 500)), (7, 12, (0, 2)),
    (4999, 2, (0, 1)), (6000, 1, (0, 3)),       # tiled short stream
])
def test_batches_match_the_reference(seq_len, global_batch, steps):
    j = JD.KGTokenPipeline(_stream(), seq_len=seq_len,
                           global_batch=global_batch)
    t = TD.KGTokenPipeline(_stream(), seq_len=seq_len,
                           global_batch=global_batch)
    assert np.array_equal(t.stream, j.stream)
    for step in steps:
        _same_batch(t.batch(step), j.batch(step))
        for n in (1, 2, global_batch):
            if global_batch % n == 0:
                for shard in range(n):
                    assert t.rows_for_shard(shard, n) == \
                        j.rows_for_shard(shard, n)
                    _same_batch(t.shard_batch(step, shard, n),
                                j.shard_batch(step, shard, n))


@pytest.mark.parametrize("weights", [[1.0, 1.0, 4.0], [3.0, 0.5, 0.5],
                                     [0.2, 0.7, 0.1]])
def test_rebalanced_shards_match_the_reference(weights):
    j = JD.KGTokenPipeline(_stream(), seq_len=32, global_batch=12)
    t = TD.KGTokenPipeline(_stream(), seq_len=32, global_batch=12)
    j.rebalance(weights)
    t.rebalance(weights)
    for shard in range(3):
        assert t.rows_for_shard(shard, 3) == j.rows_for_shard(shard, 3)
        _same_batch(t.shard_batch(5, shard, 3), j.shard_batch(5, shard, 3))
    for bad in (2, 5):                   # the reference's errors too
        with pytest.raises(ValueError):
            t.rows_for_shard(0, bad)
        with pytest.raises(ValueError):
            j.rows_for_shard(0, bad)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-2b",
                                  "whisper-large-v3", "rwkv6-7b"])
def test_random_lm_batch_matches_the_reference(arch):
    jcfg = j_reduced_config(j_get_config(arch))
    cfg = reduced_config(get_config(arch))
    for batch, seq in ((2, 32), (3, 64)):
        _same_batch(TD.random_lm_batch(np.random.default_rng(5), cfg,
                                       batch, seq),
                    JD.random_lm_batch(np.random.default_rng(5), jcfg,
                                       batch, seq))


# ---------------------------------------------------------------------------
# tests/test_data_pipeline.py on the port
# ---------------------------------------------------------------------------

def test_batch_deterministic():
    p1 = TD.KGTokenPipeline(_stream(), seq_len=32, global_batch=8)
    p2 = TD.KGTokenPipeline(_stream(), seq_len=32, global_batch=8)
    for step in (0, 1, 17):
        _same_batch(p1.batch(step), p2.batch(step))


def test_labels_are_shifted_tokens():
    b = TD.KGTokenPipeline(_stream(), seq_len=16, global_batch=4).batch(3)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_shards_partition_global_batch_and_reshard_elastically():
    p = TD.KGTokenPipeline(_stream(), seq_len=32, global_batch=8)
    full = p.batch(5)["tokens"]
    for n_shards in (1, 2, 4, 8):
        parts = [p.shard_batch(5, i, n_shards)["tokens"]
                 for i in range(n_shards)]
        np.testing.assert_array_equal(np.concatenate(parts), full)
    p.rebalance([1.0, 1.0, 4.0, 2.0])
    sizes = [p.shard_batch(0, i, 4)["tokens"].shape[0] for i in range(4)]
    assert sum(sizes) == 8 and sizes[2] > sizes[0]


@pytest.mark.parametrize("seq_len", [2, 17, 64])
@pytest.mark.parametrize("batch", [1, 5, 16])
def test_any_grid_fillable(seq_len, batch):
    p = TD.KGTokenPipeline(_stream(300), seq_len=seq_len,
                           global_batch=batch)
    for step in (0, 7, 1000):
        b = p.batch(step)
        assert b["tokens"].shape == (batch, seq_len)
        assert b["tokens"].min() >= 0 and (b["loss_mask"] >= 0).all()


def test_linearize_kg_structure():
    kg, _ = TP.mapsdi_create_kg(TS.make_group_a_dis(300, 0.9, seed=4,
                                                    device="cpu"))
    stream = TD.linearize_kg(kg, vocab_size=1024, seed=0)
    assert stream.dtype == np.int32 and stream.min() >= 0
    assert stream[0] == TD.BOT
    assert (stream == TD.EOT).sum() == (stream == TD.BOT).sum() == \
        int(kg.count)
    rows = np.split(stream, np.where(stream == TD.EOT)[0] + 1)
    assert len({tuple(r) for r in rows if len(r)}) == int(kg.count)
