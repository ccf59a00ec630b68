"""The port's Grain-equivalent pipeline (`data/grain_pipeline.py`) against the
`grain` library and the JAX package's `GrainBatches`, on the CPU.

The port runs without `grain`; these tests hold it to the library as a
black box: `index_shuffle` to grain's C++ `index_shuffle` across every
block size from 16 to 64 bits and several round counts; the sampler's
order to `grain.python.IndexSampler` read by a `DataLoader` without worker
processes, for seeds, 1/10/1000 records, 1-3 shards, shuffled or not, 2
epochs (and unbounded epochs); the batches to JAX's `GrainBatches`; the
saved input state to grain's, both ways. All exact.
"""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

grain = pytest.importorskip("grain.python")
from grain._src.python.experimental.index_shuffle.python import index_shuffle_module  # noqa: E402

from ron_tensorflow_tpu.data.grain_pipeline import GrainBatches as JaxGrainBatches  # noqa: E402
from ron_tensorflow_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig  # noqa: E402

from ron_tensorflow_tpu_torch.data.grain_pipeline import GrainBatches, IndexSampler, index_shuffle  # noqa: E402
from ron_tensorflow_tpu_torch.data.pipeline import PipelineConfig  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_grain import _write_shard  # noqa: E402

SEEDS = (0, 7, 2 ** 32 - 1)


class Keys:
    """A data source whose record i is i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i

    def __repr__(self):
        return f"Keys({self.n})"


def grain_order(n, shard, shards, shuffle, epochs, seed, limit=None):
    sampler = grain.IndexSampler(num_records=n, shard_options=grain.ShardOptions(
        shard_index=shard, shard_count=shards, drop_remainder=True), shuffle=shuffle, num_epochs=epochs, seed=seed)
    it = iter(grain.DataLoader(data_source=Keys(n), sampler=sampler, worker_count=0))
    return [int(k) for k in itertools.islice(it, limit)]


@pytest.mark.parametrize("bits", range(16, 66, 2))
def test_index_shuffle_equals_grains_library(bits):
    """Every block size: max_index just above 2^(bits-1) (the widest cycle
    walk) and at 2^bits - 1, rounds 4, 6 and 8, three seeds."""
    rng = np.random.default_rng(bits)
    for max_index in (2 ** (bits - 1) + 1, 2 ** bits - 1):
        idx = {0, 1, max_index, max_index // 2, *(int(v) for v in rng.integers(0, min(max_index, 2 ** 62), 5))}
        for seed, rounds, i in itertools.product(SEEDS, (4, 6, 8), sorted(idx)):
            want = index_shuffle_module.index_shuffle(i, max_index=max_index, seed=seed, rounds=rounds)
            assert index_shuffle(i, max_index, seed, rounds) == want, (max_index, seed, rounds, i)


def test_index_shuffle_small_ranges_are_permutations_equal_to_grain():
    for max_index in (0, 1, 2, 9, 46_204):
        got = [index_shuffle(i, max_index, 52) for i in range(max_index + 1)]
        assert sorted(got) == list(range(max_index + 1))
        assert got == [index_shuffle_module.index_shuffle(i, max_index=max_index, seed=52, rounds=4)
                       for i in range(max_index + 1)]


@pytest.mark.parametrize("n,shards", [(n, k) for n in (1, 10, 1000) for k in (1, 2, 3) if n >= k])
@pytest.mark.parametrize("shuffle", (True, False))
def test_sampler_order_equals_grain(n, shards, shuffle):
    for seed, shard in itertools.product(SEEDS[:2] if n < 1000 else SEEDS[:1], range(shards)):
        want = grain_order(n, shard, shards, shuffle, 2, seed)
        mine = IndexSampler(n, shard, shards, shuffle, 2, seed)
        assert len(mine) == len(want) == 2 * (n // shards)
        assert [mine.record_key(j) for j in range(len(want))] == want
        assert repr(mine) == repr(grain.IndexSampler(num_records=n, shard_options=grain.ShardOptions(
            shard_index=shard, shard_count=shards, drop_remainder=True), shuffle=shuffle, num_epochs=2, seed=seed))
    # unbounded epochs: the first three of the last shard
    forever = IndexSampler(n, shards - 1, shards, shuffle, None, SEEDS[0])
    want = grain_order(n, shards - 1, shards, shuffle, None, SEEDS[0], limit=3 * (n // shards))
    assert [forever.record_key(j) for j in range(len(want))] == want


def test_shards_are_disjoint_and_cover_the_kept_records():
    n, k = 1000, 3
    epoch = [set(IndexSampler(n, s, k, True, 1, 5).record_key(j) for j in range(n // k)) for s in range(k)]
    assert all(len(e) == n // k for e in epoch)
    assert not (epoch[0] & epoch[1] or epoch[0] & epoch[2] or epoch[1] & epoch[2])
    assert set().union(*epoch) == set(range((n // k) * k))


@pytest.fixture(scope="module")
def shard_file(tmp_path_factory):
    return _write_shard(tmp_path_factory.mktemp("grain_shard"), n=10)


def configs(**kw):
    base = dict(batch_size=2, working_shape=(32, 32), max_boxes=4, shuffle=True, seed=3, decode_workers=1)
    jax_kw = {k: v for k, v in {**base, **kw}.items() if k != "decode_workers"}
    return PipelineConfig(**{**base, **kw}), JaxPipelineConfig(**jax_kw)


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("shards", (1, 2))
def test_batches_equal_jax_grain_batches(shard_file, shards):
    for shard in range(shards):
        cfg, jcfg = configs(num_workers=shards, worker_index=shard)
        got = list(GrainBatches([shard_file], cfg, epochs=2))
        want = list(JaxGrainBatches([shard_file], jcfg, epochs=2))
        assert len(got) == 2 * (10 // shards) // 2
        assert_batches_equal(got, want)


def test_resume_is_exact_and_the_state_is_grains(shard_file):
    """Three batches, the state saved; a new pipeline restored from it reads
    what the straight run reads next. The state is the JSON grain's loader
    writes at that position: a state from either package restores in the
    other."""
    cfg, jcfg = configs(num_workers=2, worker_index=1)
    straight = list(GrainBatches([shard_file], cfg, epochs=3))
    first = GrainBatches([shard_file], cfg, epochs=3)
    for _ in range(3):
        next(first)
    text = first.state_json()
    resumed = GrainBatches([shard_file], cfg, epochs=3)
    resumed.restore_state_json(text)
    assert_batches_equal(list(resumed), straight[3:])

    jax_it = JaxGrainBatches([shard_file], jcfg, epochs=3)
    for _ in range(3):
        next(jax_it)
    assert text == jax_it.state_json()
    from_jax = GrainBatches([shard_file], cfg, epochs=3)
    from_jax.restore_state_json(jax_it.state_json())
    into_jax = JaxGrainBatches([shard_file], jcfg, epochs=3)
    into_jax.restore_state_json(text)
    assert_batches_equal(list(from_jax), list(into_jax))
    other, _ = configs(num_workers=2, worker_index=0)
    with pytest.raises(ValueError, match="another sampler"):
        GrainBatches([shard_file], other, epochs=3).restore_state_json(text)
