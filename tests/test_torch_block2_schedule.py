"""The block-2 kernel of K-B (`fused_vgg_block2_kernel`, csrc/fused_vgg_block1.cu)
on the CPU: the weight image its wrapper lays out, and a model of its
schedule. The kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); this rehearses what can be written as data.

- `_block2_weight_image` is read back through the 128-byte swizzle of
  `w_offset` (csrc/conv3x3_mma.cuh): chunk c of output channel co of a
  slab sits at chunk c ^ (co % 8).
- The schedule: one producer thread streams weight slabs through a ring of
  kUnits units of 8 KB (a slab takes 1 or 2), three producer warps load the input tile X, and two
  consumer warpgroups run the MMAs. The model walks each role's loops as the
  kernel writes them, and runs them under random interleavings: every
  K-step's slab has landed before its MMA is issued, no stage is refilled
  before the last MMA that reads it has retired in both consumers, X is
  reloaded only after both consumers are done with it, Y is rewritten only
  after both consumers' conv B has read it, and nothing deadlocks.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ron_tensorflow_tpu_torch.kernels import fused_conv_pool as fcp

SOURCE = (Path(fcp.__file__).resolve().parent.parent / "csrc" / "fused_vgg_block1.cu").read_text()
UNITS = int(re.search(r"constexpr int kUnits = (\d+);", SOURCE).group(1))
UNIT_BYTES = 8192
STEPS = 36  # K-steps of a conv pass: 9 taps x 4 of 16 channels
CHUNK = 64  # channels of a Ci chunk, a Y chunk and a narrow output group
Y_SLOTS = 2


def widths(c):
    """conv A's and conv B's N for output width c (conv B's: the launcher's `conv_b_n`)."""
    return CHUNK, 128 if c == 128 else CHUNK


def bf16(t):
    return t.to(torch.bfloat16).float()


# --------------------------------------------------------------------------- #
# The weight image


@pytest.mark.parametrize("cin,c", [(64, 64), (64, 128), (8, 128), (64, 192), (128, 128), (72, 192)])
def test_weight_image_reads_back_through_the_swizzle(cin, c):
    rng = np.random.default_rng(cin + c)
    for w, co_width in ((torch.as_tensor(rng.normal(size=(c, cin, 3, 3)), dtype=torch.float32), widths(c)[0]),
                        (torch.as_tensor(rng.normal(size=(c, c, 3, 3)), dtype=torch.float32), widths(c)[1])):
        image = fcp._block2_weight_image(w, co_width)
        ci = w.shape[1]
        nci = -(-ci // CHUNK)
        assert image.dtype == torch.bfloat16 and image.is_contiguous()
        assert image.shape == (c // co_width, nci, 9, co_width, CHUNK)
        flat = image.reshape(-1).float()
        g, j, t, co, k = np.meshgrid(np.arange(c // co_width), np.arange(nci), np.arange(9), np.arange(co_width),
                                     np.arange(CHUNK), indexing="ij")
        slab = (g * nci + j) * 9 + t
        at = slab * co_width * CHUNK + co * CHUNK + (((k // 8) ^ (co & 7)) * 8) + k % 8  # w_offset / 2
        ch = j * CHUNK + k
        want = torch.zeros(at.shape)
        inside = ch < ci
        want[torch.as_tensor(inside)] = bf16(w)[g * co_width + co, np.minimum(ch, ci - 1), t // 3, t % 3][
            torch.as_tensor(inside)]
        torch.testing.assert_close(flat[torch.as_tensor(at)], want, rtol=0, atol=0)


def test_weight_image_is_a_permutation_of_the_padded_weights():
    """Every element of the image is one of w's (or a padding zero), each once."""
    w = torch.arange(128 * 64 * 9, dtype=torch.float32).reshape(128, 64, 3, 3) % 251
    image = fcp._block2_weight_image(w, 128).float().reshape(-1)
    assert image.numel() == w.numel()
    assert torch.equal(image.sort().values, bf16(w).reshape(-1).sort().values)


def test_weight_image_is_kept_until_the_weights_change():
    """The wrapper lays a weight tensor out once; an in-place update (an
    optimizer step) or another slab width makes a new image."""
    w = torch.randn(128, 64, 3, 3)
    first = fcp._cached_weight_image(w, 64)
    assert fcp._cached_weight_image(w, 64) is first
    assert fcp._cached_weight_image(w, 128) is not first
    w.add_(1.0)
    again = fcp._cached_weight_image(w, 128)
    torch.testing.assert_close(again, fcp._block2_weight_image(w, 128), rtol=0, atol=0)
    assert fcp._cached_weight_image(w.clone(), 128) is not again  # another tensor, its own image
    with torch.inference_mode():  # no version counter: laid out at each call
        wi = w * 1.0
        torch.testing.assert_close(fcp._cached_weight_image(wi, 128), again, rtol=0, atol=0)
        assert fcp._cached_weight_image(wi, 128) is not fcp._cached_weight_image(wi, 128)


# --------------------------------------------------------------------------- #
# The schedule, as each role of the kernel walks it


def passes(cin, c):
    """For one tile: [(n, pair, conv A groups, conv B chunks)] in the kernel's order; conv A groups are
    empty where Y already holds the map (the resident schedule's later output groups)."""
    na, nb = widths(c)
    nc, ng = c // CHUNK, c // nb
    resident = nb == 128
    npairs = 1 if resident else -(-nc // Y_SLOTS)
    out = []
    for n in range(ng):
        for pr in range(npairs):
            k0, k1 = Y_SLOTS * pr, min(Y_SLOTS * pr + Y_SLOTS, nc)
            groups = list(range(k0 * CHUNK // na, k1 * CHUNK // na)) if (not resident or n == 0) else []
            out.append((n, pr, groups, list(range(k0, k1))))
    return out


def producer_slabs(cin, c):
    """The weight thread's slabs for one tile: (conv, group or output group, chunk, tap, bytes)."""
    na, nb = widths(c)
    nci, nc = -(-cin // CHUNK), c // CHUNK
    slabs = []
    for n, _, groups, chunks in passes(cin, c):
        for k in groups:
            slabs += [("A", k, j, t, na * CHUNK * 2) for j in range(nci) for t in range(9)]
        slabs += [("B", n, k, t, nb * CHUNK * 2) for k in chunks for t in range(9)]
    return slabs


def x_loads(cin, c):
    """The X loaders' loads for one tile (Ci chunk of each)."""
    nci = -(-cin // CHUNK)
    if nci == 1:
        return [0]
    return [j for _, _, groups, _ in passes(cin, c) for _ in groups for j in range(nci)]


def consumer_ops(cin, c):
    """One consumer's operations for one tile, as the kernel's consumer loop issues them; Y fillings
    are numbered from 0 within the tile."""
    nci = -(-cin // CHUNK)
    ops, slab = [], 0
    plan = passes(cin, c)
    last_a = max(i for i, (_, _, groups, _) in enumerate(plan) if groups)

    def conv(kind, tag):
        nonlocal slab
        for s in range(STEPS):
            q = slab + s // 4
            if s % 4 == 0:
                ops.append(("wait", q))
            ops.append(("mma", q, kind, tag))
            if s + 1 < STEPS:
                ops.append(("wait_group", 1))
                if s % 4 == 0 and s > 0:
                    ops.append(("release", q - 1))
        ops.append(("wait_group", 0))
        ops.append(("release", slab + 8))
        slab += 9

    filling = -1
    for i, (n, pr, groups, chunks) in enumerate(plan):
        if groups:
            filling += 1
        for gi, k in enumerate(groups):
            for j in range(nci):
                ops.append(("xwait",))
                conv("A", (k, j))
                if nci > 1 or (i == last_a and gi == len(groups) - 1):
                    ops.append(("xrelease",))
            if gi == 0:
                ops.append(("bar", "Y free"))
            ops.append(("ywrite", filling))
        if groups:
            ops.append(("bar", "Y written"))
        ops.append(("yread_begin", filling))
        for k in chunks:
            conv("B", (n, k))
        if i + 1 == len(plan) or plan[i + 1][2]:
            ops.append(("yread_end", filling))
        if i + 1 == len(plan) or plan[i + 1][0] != n:
            ops.append(("epilogue", n))
    return ops


@pytest.mark.parametrize("cin,c", [(64, 128), (64, 64), (64, 192), (128, 128), (192, 128), (8, 8 * 8), (128, 256)])
def test_consumers_read_the_slabs_in_the_producers_order(cin, c):
    slabs = producer_slabs(cin, c)
    mma = [op for op in consumer_ops(cin, c) if op[0] == "mma"]
    assert len(mma) == 4 * len(slabs)
    for op in mma:  # slab q holds the weights of the conv and the indices its MMAs use
        kind, q = op[2], op[1]
        assert slabs[q][0] == kind
        assert (slabs[q][1], slabs[q][2]) == op[3]
    released = [op[1] for op in consumer_ops(cin, c) if op[0] == "release"]
    assert released == list(range(len(slabs)))


def test_l2_bytes_a_tile_at_block_2():
    """At [.., 64] -> 128 a tile streams conv A's 9 x 128 x 64 and conv B's 2 x 9 x 128 x 64 bf16 weights
    once: 442 368 B, 36 slabs; ~1.42 GB over the 3 200 tiles of [32, 160, 160]."""
    slabs = producer_slabs(64, 128)
    assert sum(s[4] for s in slabs) == 2 * 9 * 64 * (128 + 128 * 2) == 442_368
    assert len(slabs) == 18 + 18
    assert max(s[4] for s in slabs) <= 2 * UNIT_BYTES
    assert 32 * (160 // 8) * (160 // 32) == 3200


def simulate(cin, c, tiles, seed):
    """Runs the weight thread, the X loaders and both consumers for `tiles` tiles under one random
    interleaving, asserting the kernel's invariants at every operation. Returns the operations run."""
    rng = random.Random(seed)
    per_tile, fillings = len(producer_slabs(cin, c)), 1 + max(
        op[1] for op in consumer_ops(cin, c) if op[0] == "ywrite")
    slabs = producer_slabs(cin, c) * tiles
    xl = x_loads(cin, c) * tiles
    cons = []
    for t in range(tiles):  # slab and Y-filling numbers run on across tiles
        for op in consumer_ops(cin, c):
            if op[0] in ("wait", "release", "mma"):
                op = (op[0], op[1] + t * per_tile) + op[2:]
            elif op[0] in ("ywrite", "yread_begin", "yread_end"):
                op = (op[0], op[1] + t * fillings)
            cons.append(op)
    units = [sz // UNIT_BYTES for *_, sz in slabs]
    start = np.concatenate([[0], np.cumsum(units)]).tolist()  # slab i holds ring units start[i]..start[i + 1]
    for i, u in enumerate(units):
        assert start[i] % UNITS + u <= UNITS, "a slab runs over the ring's end"
    pos = {"P": 0, "X": 0, 0: 0, 1: 0}
    filled = xfilled = 0
    released, x_released = [0, 0], [0, 0]  # slabs, X loads each consumer has handed back
    holding_x = [False, False]
    inflight = [[], []]  # each consumer's committed MMA groups, by slab
    written, read = [0, 0], [0, 0]  # Y fillings each consumer has written, and finished reading
    run = 0

    def runnable(who):
        if who == "P":
            i = pos["P"]  # its units' tenants a lap back are handed back by both consumers
            return i < len(slabs) and min(start[released[0]], start[released[1]]) >= start[i + 1] - UNITS
        if who == "X":
            return pos["X"] < len(xl) and min(x_released) >= pos["X"]
        if pos[who] >= len(cons):
            return False
        op = cons[pos[who]]
        if op[0] == "wait":
            return filled > op[1]
        if op[0] == "xwait":
            return xfilled > x_released[who]
        if op[0] == "bar":  # a named barrier of the two consumers
            other = cons[pos[1 - who]] if pos[1 - who] < len(cons) else None
            return other is not None and other[0] == "bar"
        return True

    weights = {}
    while True:
        ready = [w for w in ("P", "X", 0, 1) if runnable(w)]
        if not ready:
            break
        if run % 64 == 0:  # bursts: for a while one role may run far ahead of the others
            weights = {w: rng.expovariate(1.0) ** 4 + 1e-6 for w in ("P", "X", 0, 1)}
        who = rng.choices(ready, [weights[w] for w in ready])[0]
        run += 1
        if who == "P":  # refill units: no MMA in flight reads what they held a lap back
            lo, hi = start[filled] - UNITS, start[filled + 1] - UNITS
            assert all(start[q + 1] <= lo or start[q] >= hi for g in inflight[0] + inflight[1] for q in g)
            filled += 1
            pos["P"] += 1
            continue
        if who == "X":
            assert not any(holding_x), "X reloaded under a consumer's conv A"
            xfilled += 1
            pos["X"] += 1
            continue
        op = cons[pos[who]]
        kind = op[0]
        if kind == "mma":
            q = op[1]
            assert released[who] <= q < filled, "a K-step's slab has landed and is still held"
            assert start[filled] <= start[q] + UNITS, "the ring still holds this slab"
            if op[2] == "A":
                assert holding_x[who]
            inflight[who].append({q})
        elif kind == "wait_group":
            inflight[who] = inflight[who][len(inflight[who]) - op[1]:] if op[1] else []
        elif kind == "release":
            assert op[1] == released[who]
            assert all(op[1] not in g for g in inflight[who]), "a stage released before its last reader retired"
            released[who] += 1
        elif kind == "xwait":
            holding_x[who] = True
        elif kind == "xrelease":
            assert not inflight[who]
            holding_x[who] = False
            x_released[who] += 1
        elif kind == "bar":
            other = cons[pos[1 - who]]
            assert other == op, "the consumers meet at the same barrier"
            pos[1 - who] += 1
            if op[1] == "Y written":
                written[0] += 1
                written[1] += 1
        elif kind == "ywrite":
            assert min(read) >= op[1], "Y rewritten before both consumers' conv B read it"
        elif kind == "yread_begin":
            assert min(written) >= op[1] + 1, "conv B reads Y before both consumers wrote it"
        elif kind == "yread_end":
            read[who] = op[1] + 1
        pos[who] += 1
    assert pos["P"] == len(slabs) and pos["X"] == len(xl), "the producer stalled: deadlock"
    assert pos[0] == pos[1] == len(cons), "a consumer stalled: deadlock"
    assert released == [len(slabs)] * 2 and x_released == [len(xl)] * 2
    return run


@pytest.mark.parametrize("cin,c", [(64, 128), (64, 64), (64, 192), (128, 128), (192, 128), (128, 256)])
def test_ring_schedule_holds_under_random_interleavings(cin, c):
    for seed in range(8):
        assert simulate(cin, c, tiles=3, seed=seed) > 0
