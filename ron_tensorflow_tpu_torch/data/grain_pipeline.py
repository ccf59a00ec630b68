"""Grain-equivalent input pipeline: deterministic, shardable by index,
resumable at the exact input position.

Port of `ron_tensorflow_tpu/data/grain_pipeline.py` without its dependency:
the port's host need not have `grain`, so its sampler is ported here and
gives, for the same seed, record count, shard options and epochs, the order
of `grain.python.IndexSampler` read by a `grain.python.DataLoader` with no
worker processes (what the JAX trainer builds):

- the records are `range(n)`; sharding with drop_remainder keeps shard i's
  consecutive block [i * n // k, (i + 1) * n // k) (`sharding.even_split`);
- a shuffle permutes each epoch of the shard's L records with grain's
  `index_shuffle(index, max_index=L - 1, seed=(seed + epoch) % 2**32,
  rounds=4)`: a Simon-style Feistel network over a block of
  b = max(ceil(log2(L - 1)) rounded up to even, 16) bits, b / 2 bits a
  half, round keys from `std::seed_seq{seed}.generate`, cycle-walked until
  the value falls in [0, L - 1] (`index_shuffle`, read from grain's C++
  library; its pure-Python `index_shuffle_python.py` gives another
  permutation and is not what the sampler runs);
- shard s's j-th record is the sampler's global index j * k + s, whose key
  is the shuffled sequence's j-th entry; the loader stops at the sampler's
  length, num_epochs * (n // k) * k.

`TFRecordVocSource` decodes a record to the same sample dict as JAX's, and
`GrainBatches` stacks `batch_size` of them (the last short batch dropped,
as `grain.python.Batch(drop_remainder=True)` does). Its `state_json` is
grain's DataLoader state for the position (`last_seen_indices` etc.), so a
state written by either package restores in the other.
"""

from __future__ import annotations

import functools
import json
import math
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import native
from .decode import decode_jpeg
from .pipeline import PipelineConfig, _apply_difficult_policy, _pad_gt, parse_voc_example

_M32 = 0xFFFFFFFF
MIN_BLOCK_BITS = 16  # grain's kMinBlockSize
SHUFFLE_ROUNDS = 4  # ShuffleMapDataset's rounds


def _seed_seq_generate(seeds: Sequence[int], n: int) -> List[int]:
    """`std::seed_seq(seeds).generate` of n 32-bit words ([rand.util.seedseq])."""
    out = [0x8B8B8B8B] * n
    if n == 0:
        return out
    s = len(seeds)
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(out[k % n] ^ out[(k + p) % n] ^ out[(k - 1) % n])) & _M32
        r2 = (r1 + (s if k == 0 else k % n + seeds[k - 1] if k <= s else k % n)) & _M32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _M32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _M32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((out[k % n] + out[(k + p) % n] + out[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


@functools.lru_cache(maxsize=64)
def _round_keys(seed: int, rounds: int) -> tuple:
    return tuple(_seed_seq_generate([seed], rounds))


def _simon_encrypt(value: int, keys: Sequence[int], half: int) -> int:
    """grain's `simon_encrypt<half>`: two Feistel half-rounds per key pair,
    f(x) = (rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2) on `half`-bit words."""
    mask = (1 << half) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (half - r))) & mask

    def f(x):
        return (rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2)

    left, right = (value >> half) & mask, value & mask
    for i in range(0, len(keys) - 1, 2):
        left ^= f(right) ^ (keys[i] & mask)
        right ^= f(left) ^ (keys[i + 1] & mask)
    return (left << half) | right


def index_shuffle(index: int, max_index: int, seed: int, rounds: int = SHUFFLE_ROUNDS) -> int:
    """Position of `index` in grain's pseudorandom permutation of
    [0, max_index] (`grain::random::index_shuffle`)."""
    if max_index == 0:
        return 0
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4, got {rounds}")
    bits = math.ceil(math.log2(float(max_index)))
    bits = max(bits + bits % 2, MIN_BLOCK_BITS)
    if bits > 64:
        raise ValueError(f"max_index {max_index} needs more than 64 bits")
    keys = _round_keys(seed & _M32, rounds)
    x = index
    while True:
        x = _simon_encrypt(x, keys, bits // 2)
        if x <= max_index:
            return x


class IndexSampler:
    """The record keys that shard `shard_index` of `shard_count` reads, in
    order: grain's IndexSampler (drop_remainder sharding) as its DataLoader
    walks it without worker processes. `num_epochs` None = forever."""

    def __init__(self, num_records: int, shard_index: int = 0, shard_count: int = 1, shuffle: bool = False,
                 num_epochs: Optional[int] = None, seed: Optional[int] = None):
        if num_records <= 0:
            raise ValueError(f"need at least one record, got {num_records}")
        if shuffle and seed is None:
            raise ValueError("shuffling needs a seed")
        if seed is not None and (seed < 0 or seed.bit_length() > 32):
            raise ValueError("seed must be a non-negative 32-bit integer")
        self.num_records, self.shard_index, self.shard_count = num_records, shard_index, shard_count
        self.shuffle, self.num_epochs, self.seed = shuffle, num_epochs, seed
        self.shard_len = num_records // shard_count
        if self.shard_len == 0:
            raise ValueError(f"{num_records} records leave shard {shard_index} of {shard_count} empty")
        self.shard_start = self.shard_len * shard_index

    def __len__(self) -> int:
        """Records this shard reads (None epochs: unbounded)."""
        return 2 ** 63 - 1 if self.num_epochs is None else self.num_epochs * self.shard_len

    def __repr__(self) -> str:
        """grain's IndexSampler repr, which its loader state records."""
        opts = (f"ShardOptions(shard_index={self.shard_index}, shard_count={self.shard_count}, "
                f"drop_remainder=True)")
        return (f"IndexSampler(num_records={self.num_records}, shard_options={opts}, shuffle={self.shuffle}, "
                f"num_epochs={self.num_epochs}, seed={self.seed})")

    def record_key(self, j: int) -> int:
        """The record of this shard's j-th read."""
        epoch, i = divmod(j, self.shard_len)
        if self.shuffle:
            i = index_shuffle(i, self.shard_len - 1, (self.seed + epoch) % 2 ** 32)
        return self.shard_start + i


def _index_records(path: str) -> List[tuple]:
    """[(offset, length), ...] for every record payload in a shard."""
    with open(path, "rb") as f:
        buf = f.read()
    if native.get_lib() is not None:
        offsets, lengths = native.scan_records(buf, verify=True)
        return list(zip(offsets.tolist(), lengths.tolist()))
    spans, pos = [], 0  # without a C compiler: walk the framing
    while pos + 12 <= len(buf):
        (length,) = struct.unpack("<Q", buf[pos: pos + 8])
        if pos + 12 + length + 4 > len(buf):
            raise IOError(f"truncated TFRecord shard {path}: record at offset {pos} claims {length} payload bytes "
                          f"but only {len(buf) - pos - 12} remain")
        spans.append((pos + 12, length))
        pos += 12 + length + 4
    return spans


class TFRecordVocSource:
    """Random access to the records of VOC TFRecord shards: `source[i]` is
    the decoded, GT-padded sample dict (image01 uint8 at the working canvas
    and the padded gts), as JAX's `TFRecordVocSource` gives it."""

    def __init__(self, files: Sequence[str], config: PipelineConfig):
        self._files = list(files)
        self._config = config
        self._spans = [(fi, off, ln) for fi, path in enumerate(self._files) for off, ln in _index_records(path)]
        self._fds: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._spans)

    def __repr__(self) -> str:
        names = ",".join(os.path.basename(p) for p in self._files)
        return (f"TFRecordVocSource(files=[{names}], records={len(self._spans)}, "
                f"canvas={tuple(self._config.working_shape)})")

    def _read(self, fi: int, off: int, ln: int) -> bytes:
        fd = self._fds.get(fi)
        if fd is None:
            fd = self._fds[fi] = os.open(self._files[fi], os.O_RDONLY)
        return os.pread(fd, ln, off)  # positioned: safe from decode threads

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self._config
        sample = _apply_difficult_policy(parse_voc_example(self._read(*self._spans[index])), cfg.keep_difficult)
        image = (decode_jpeg(sample["jpeg"], cfg.working_shape) * 255.0 + 0.5).astype(np.uint8)
        gt = _pad_gt(sample, cfg.max_boxes)
        return {"image01": image, "gt_labels": gt["labels"], "gt_boxes": gt["boxes"], "gt_valid": gt["valid"],
                "gt_difficult": gt["difficult"]}


class GrainBatches:
    """Batches of `config.batch_size` records in the sampler's order, for
    shard `config.worker_index` of `config.num_workers`, shuffled with
    `config.seed` when `config.shuffle`; `state_json` / `restore_state_json`
    save and restore the input position. A batch's records decode on
    `config.decode_workers` threads (order-preserving). `last_keys` holds
    the record keys (indices into the source) of the batch returned last."""

    def __init__(self, files, config: PipelineConfig, epochs=None):
        self.source = TFRecordVocSource(files, config)
        self.sampler = IndexSampler(len(self.source), config.worker_index, config.num_workers, config.shuffle,
                                    epochs, config.seed)
        self.batch_size = config.batch_size
        self.next_index = 0  # records of this shard read so far
        self.last_keys: List[int] = []
        workers = config.decode_workers if config.decode_workers != -1 else min(8, (os.cpu_count() or 2) - 1)
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 1 else None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        j0 = self.next_index
        if j0 + self.batch_size > len(self.sampler):
            raise StopIteration
        keys = [self.sampler.record_key(j) for j in range(j0, j0 + self.batch_size)]
        samples = list(self._pool.map(self.source.__getitem__, keys) if self._pool else map(self.source.__getitem__,
                                                                                           keys))
        self.next_index = j0 + self.batch_size
        self.last_keys = keys
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        batch["sample_valid"] = np.ones((self.batch_size,), bool)
        return batch

    def state_json(self) -> str:
        """grain's DataLoader state (worker_count 0) at this position, as
        JAX's `GrainBatches.state_json` writes it (grain's JSON text, itself
        JSON-encoded)."""
        s = self.sampler
        return json.dumps(json.dumps({
            "version": 2,
            "last_seen_indices": {"0": s.shard_index - s.shard_count + self.next_index * s.shard_count},
            "last_worker_index": -1,
            "worker_count": 0,
            "sampler": repr(s),
            "data_source": repr(self.source),
        }, indent=4))

    def restore_state_json(self, text: str) -> None:
        state = json.loads(json.loads(text))
        if state["sampler"] != repr(self.sampler) or state["data_source"] != repr(self.source):
            raise ValueError("input state was written for another sampler or data source:\n"
                             f"{state['sampler']}, {state['data_source']}")
        s = self.sampler
        self.next_index = (state["last_seen_indices"]["0"] + s.shard_count - s.shard_index) // s.shard_count
