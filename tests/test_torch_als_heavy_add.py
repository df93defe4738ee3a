"""ALS's heavy sums off the card: :func:`heavy_order`'s flat plan (what
``csrc/als_heavy_add.cu`` reads) agrees with its buckets slot for slot;
a walk of the flat plan, level by level as the plain version adds and
in eights and a binary counter as the kernel adds, gives
``_heavy_stats``'s bits;
``_heavy_stats`` on a CPU tensor launches nothing; the kernel wrapper's
checks refuse what the kernel does not take before any library is
loaded, and a group with no slot launches nothing; the C signature the
loader declares is the one the CUDA source defines; and an ml20m epoch
at the benchmark configuration's degrees is 12 launches. The kernel
itself is held to the plain version on the card
(``tests/test_torch_gpu.py``)."""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import _build, als

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "predictionio_tpu_torch" / "csrc" / "als_heavy_add.cu"
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "int": ctypes.c_int}
CPU = torch.device("cpu")
N_REGULAR = 40

#: owners' sub-row counts in one group (padded widths 1, 2, 4, 128, 128,
#: 8 and 1; then 1,024, 4, 1 and 256, which the kernel splits into 8
#: parts), and the phantom sub-rows (owner 0) among them
GROUPS = {
    "widths-1-2-128": ([1, 2, 3, 128, 65, 5, 1], 4),
    "phantoms-only": ([], 6),
    "one-sub-row": ([1], 0),
    "wide-in-parts": ([600, 3, 1, 130], 2),
}


def _owner(counts, n_phantom, seed):
    """A group's owner column: slot ``s`` (stats position ``N_REGULAR +
    s``) owns ``counts[s]`` sub-rows, phantoms own position 0; rows in a
    seeded order, so an owner's sub-rows are neither consecutive nor
    first."""
    owner = np.concatenate(
        [np.full(c, N_REGULAR + s, np.int64) for s, c in enumerate(counts)]
        + [np.zeros(n_phantom, np.int64)])
    return np.random.default_rng(seed).permutation(owner)


def _stats(r, k, seed):
    """A group's gather-Gramian outputs, float32 values whose magnitudes
    span six decades, so that another order of the adds gives other
    bits."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 * 10.0 ** rng.uniform(-3, 3, shape))
                                .astype(np.float32))
    return draw(r, k, k), draw(r, k), draw(r)


def _packed(ga, gb, gcnt):
    """The group's stats rows and the zero row after them."""
    g = torch.cat([ga.reshape(ga.shape[0], -1), gb, gcnt[:, None]], dim=1)
    return torch.cat([g, g.new_zeros((1, g.shape[1]))])


@pytest.mark.parametrize("case", list(GROUPS))
def test_the_flat_plan_is_the_buckets_slot_for_slot(case):
    counts, n_phantom = GROUPS[case]
    owner = _owner(counts, n_phantom, 1)
    order = als.heavy_order(owner, N_REGULAR, CPU)
    assert order.plan.dtype == order.members.dtype == torch.int32
    from_buckets = {}
    for slots, rows, width in order.buckets:
        for slot, sub in zip(slots.tolist(),
                             rows.view(len(slots), width).tolist()):
            from_buckets[slot] = (width, sub)
    from_plan = {}
    members = order.members.tolist()
    for slot, width, off in order.plan.tolist():
        assert slot not in from_plan  # each slot once: no atomics needed
        from_plan[slot] = (width, members[off:off + width])
    assert from_plan == from_buckets
    assert len(members) == sum(w for w, _ in from_plan.values())
    # each slot's real sub-rows ascending, then the zero row, to a power
    # of two; no phantom planned
    for slot, (width, sub) in from_plan.items():
        real = np.nonzero(owner == N_REGULAR + slot)[0].tolist()
        assert sub == real + [len(owner)] * (width - len(real))
        assert width == 1 << max(len(real) - 1, 0).bit_length()
    assert sorted(from_plan) == list(range(len(counts)))
    assert {w for w, _ in from_plan.values()} == {
        1 << max(c - 1, 0).bit_length() for c in counts}
    widest = max((w for w, _ in from_plan.values()), default=1)
    assert order.parts == min(32, max(1, widest // 128))


def test_an_empty_group_plans_nothing():
    order = als.heavy_order(np.zeros(0, np.int64), N_REGULAR, CPU)
    assert order.buckets == []
    assert order.plan.shape == (0, 3) and order.members.numel() == 0


def _level_walk(g, order, acc):
    """The flat plan as the plain version adds: each slot's members added
    pairwise level by level, the total into its slot."""
    members = order.members.tolist()
    for slot, width, off in order.plan.tolist():
        level = [g[m] for m in members[off:off + width]]
        while len(level) > 1:
            level = [level[i] + level[i + 1] for i in range(0, len(level), 2)]
        acc[slot] = acc[slot] + level[0]


def _subtree(v):
    """A power-of-two run of members as the kernel sums one part: under 8
    read whole and summed as its tree; else eight at a time, each eight
    summed as their three-level tree, whose total climbs a binary counter
    (a level for each trailing one bit of the batch's number, added to
    the partial sum waiting there; it waits at the first zero bit); the
    last climb is the total."""
    if len(v) == 1:
        return v[0]
    if len(v) == 2:
        return v[0] + v[1]
    if len(v) == 4:
        return (v[0] + v[1]) + (v[2] + v[3])
    wait = {}
    for b in range(len(v) // 8):
        e = v[8 * b:8 * b + 8]
        x = ((e[0] + e[1]) + (e[2] + e[3])) + ((e[4] + e[5]) + (e[6] + e[7]))
        level = 0
        while (b >> level) & 1:
            x = wait[level] + x
            level += 1
        wait[level] = x
    return x


def _kernel_walk(g, order, acc):
    """The flat plan as the kernel adds: each slot's members in
    ``min(parts, width)`` aligned parts, each summed by :func:`_subtree`,
    the parts' totals then added level by level."""
    members = order.members.tolist()
    for slot, width, off in order.plan.tolist():
        parts = min(order.parts, width)
        size = width // parts
        level = [_subtree([g[m] for m in members[off + p * size:
                                                 off + (p + 1) * size]])
                 for p in range(parts)]
        while len(level) > 1:
            level = [level[i] + level[i + 1] for i in range(0, len(level), 2)]
        acc[slot] = acc[slot] + level[0]


@pytest.mark.parametrize("walk", [_level_walk, _kernel_walk],
                         ids=["levels", "kernel"])
@pytest.mark.parametrize("k", [1, 6, 32])
def test_a_walk_of_the_flat_plan_is_the_plain_versions_bits(k, walk):
    """Three groups into one buffer, slots shared between them: the walk
    gives the plain version's bits; a chain in row order does not."""
    n_slots = len(GROUPS["widths-1-2-128"][0])
    acc = torch.zeros((n_slots, k * k + k + 1))
    want = acc.clone()
    chain = acc.clone()
    for seed, case in enumerate(GROUPS):
        owner = _owner(*GROUPS[case], seed)
        order = als.heavy_order(owner, N_REGULAR, CPU)
        ga, gb, gcnt = _stats(len(owner), k, seed)
        als._heavy_add_plain(ga, gb, gcnt, order, want)
        g = _packed(ga, gb, gcnt)
        walk(g, order, acc)
        for slot in range(n_slots):
            rows = np.nonzero(owner == N_REGULAR + slot)[0].tolist()
            if rows:
                total = g[rows[0]]
                for r in rows[1:]:
                    total = total + g[r]
                chain[slot] = chain[slot] + total
    assert torch.equal(acc, want)
    assert want.abs().sum() > 0
    if k > 1:
        assert not torch.equal(chain, want)


@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "explicit"])
def test_heavy_stats_on_the_cpu_is_the_walk_and_launches_nothing(implicit):
    """``_heavy_stats`` over a packing's groups: the kernel's walk of each
    group's flat plan, packed views of one buffer, and no launch."""
    rng = np.random.default_rng(2)
    rows = np.concatenate([rng.integers(0, 30, 600),
                           np.repeat([3, 17], [260, 90])]).astype(np.int32)
    cols = rng.integers(0, 50, len(rows)).astype(np.int32)
    vals = rng.integers(1, 6, len(rows)).astype(np.float32)
    packed = als.build_bucketed(rows, cols, vals, 30, block_len=4, s_max=2,
                                max_slab_slots=64)
    n_regular = sum(s.idx.shape[0] for s in packed.slabs)
    n_slots = packed.n_stat_rows - n_regular
    assert len(packed.heavy) > 2
    y = torch.from_numpy(rng.standard_normal((50, 5)).astype(np.float32))
    groups = [(torch.from_numpy(h.idx), torch.from_numpy(h.weights),
               torch.from_numpy(h.valid),
               als.heavy_order(owner, n_regular, CPU))
              for h, owner in zip(packed.heavy, packed.heavy_owner_pos)]
    before = dict(_build.LAUNCHES)
    ha, hb, hcnt = als._heavy_stats(y, groups, n_slots, implicit, 2.0, None)
    assert _build.LAUNCHES == before
    k = y.shape[1]
    assert ha.untyped_storage().data_ptr() == hb.untyped_storage() \
        .data_ptr() == hcnt.untyped_storage().data_ptr()
    assert {_build.lead_stride(t, "t", "t") for t in (ha, hb, hcnt)} == {
        k * k + k + 1}
    want = torch.zeros((n_slots, k * k + k + 1))
    for idx, weights, valid, order in groups:
        stats = als._slab_stats_plain(y, idx, weights, valid, implicit, 2.0)
        _kernel_walk(_packed(*stats), order, want)
    got = torch.cat([ha.reshape(n_slots, -1), hb, hcnt[:, None]], dim=1)
    assert torch.equal(got, want)


def _no_build(name):
    raise AssertionError(f"built {name}")


def _refused(case):
    k, r = 4, 6
    ga, gb, gcnt = torch.zeros(r, k, k), torch.zeros(r, k), torch.zeros(r)
    acc = torch.zeros(3, k * k + k + 1)
    order = als.heavy_order(np.asarray([N_REGULAR] * 4 + [N_REGULAR + 2] * 2),
                            N_REGULAR, CPU)
    if case == "rank-129":
        k = als.SOLVE_MAX_K + 1
        ga, gb = torch.zeros(r, k, k), torch.zeros(r, k)
        acc = torch.zeros(3, k * k + k + 1)
    elif case == "ga-float64":
        ga = ga.double()
    elif case == "gb-shape":
        gb = torch.zeros(r, k + 1)
    elif case == "gcnt-rows":
        gcnt = torch.zeros(r + 1)
    elif case == "acc-width":
        acc = torch.zeros(3, k * k + k)
    elif case == "acc-device":
        acc = torch.zeros(3, k * k + k + 1, device="meta")
    elif case == "strided-ga":
        ga = torch.zeros(r, k, 2 * k)[:, :, ::2]
    elif case == "plan-int64":
        order = dataclasses.replace(order, plan=order.plan.long())
    elif case == "members-strided":
        order = dataclasses.replace(
            order, members=order.members.repeat_interleave(2)[::2])
    elif case == "parts-3":
        order = dataclasses.replace(order, parts=3)
    return ga, gb, gcnt, order, acc


@pytest.mark.parametrize("case", [
    "rank-129", "ga-float64", "gb-shape", "gcnt-rows", "acc-width",
    "acc-device", "strided-ga", "plan-int64", "members-strided", "parts-3"])
def test_what_the_kernel_does_not_take_is_refused_before_a_build(
        case, monkeypatch):
    monkeypatch.setattr(_build, "library", _no_build)
    before = _build.LAUNCHES["als_heavy_add"]
    with pytest.raises(ValueError, match="_heavy_stats"):
        als._heavy_add_kernel(*_refused(case))
    assert _build.LAUNCHES["als_heavy_add"] == before


def test_a_group_with_no_slot_launches_nothing(monkeypatch):
    monkeypatch.setattr(_build, "library", _no_build)
    order = als.heavy_order(np.zeros(5, np.int64), N_REGULAR, CPU)
    acc = torch.zeros(2, 21)
    before = _build.LAUNCHES["als_heavy_add"]
    als._heavy_add_kernel(torch.zeros(5, 4, 4), torch.zeros(5, 4),
                          torch.zeros(5), order, acc)
    assert _build.LAUNCHES["als_heavy_add"] == before
    assert not acc.any()


def test_the_loader_declares_the_sources_c_signature():
    src = SOURCE.read_text()
    (params,) = re.findall(r"int pio_als_heavy_add\(([^)]*)\)", src)
    want = []
    for param in params.split(","):
        ctype = re.sub(r"\s+", " ", param.strip()).rsplit(" ", 1)[0]
        want.append(C_TYPES[ctype.replace(" *", "*")])
    assert _build.SIGNATURES["als_heavy_add"]["pio_als_heavy_add"] == (
        ctypes.c_int, want)
    assert "als_heavy_add" in _build.LAUNCHES
    assert "als_heavy_add" not in _build._loaded  # nothing built on the CPU


def test_ml20m_epoch_is_12_heavy_add_launches():
    """At the benchmark configuration's degrees and ``train_als``'s
    default packing, an epoch's heavy groups (2 of users, 10 of items)
    each plan at least one slot: 12 launches, 3,041 slot entries (an
    owner split over two groups takes one in each), 21,395 sub-rows,
    28,702 members with the zero rows, widths up to 128, so the kernel
    splits no slot into parts."""
    from portbench.harness import generate

    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "rec-ml20m-r32.json").read_text())
    launches, slots, sub_rows, members, widest, parts = [], 0, 0, 0, 0, set()
    for side, n in (("users", cfg["n_users"]), ("items", cfg["n_items"])):
        deg = generate.degrees(cfg["degrees"][side], n,
                               cfg["n_interactions"], "cpu").numpy()
        rows = np.repeat(np.arange(n, dtype=np.int32), deg)
        packed = als.build_bucketed(rows, np.zeros_like(rows),
                                    np.ones(len(rows), np.float32), n)
        n_regular = sum(s.idx.shape[0] for s in packed.slabs)
        for owner in packed.heavy_owner_pos:
            order = als.heavy_order(owner, n_regular, CPU)
            launches.append(order.plan.shape[0] > 0)
            slots += order.plan.shape[0]
            members += order.members.numel()
            sub_rows += int((order.members < len(owner)).sum())
            widest = max(widest, int(order.plan[:, 1].max()))
            parts.add(order.parts)
        del rows, packed
    assert launches == [True] * 12
    assert (slots, sub_rows, members, widest) == (3041, 21395, 28702, 128)
    assert parts == {1}  # no slot of the cell is split
