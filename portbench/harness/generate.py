"""The interaction generator: one function, driven by a configuration's
published statistics and a traffic file.

Each side's degrees (interactions a user, interactions an item) come
from the configuration's ``degrees``: for each side a ``head``, the
published counts of its most active rows (rank 1 first), a ``min``, the
least a row has, and a ``law`` for the ranks from the head's last on,
fitted so that the whole side sums to the configuration's interactions:

* ``zipf_mandelbrot``: ``C·(r + q)^-s`` from the head's last count down
  to ``min`` at the last rank (a long tail of rows with a few
  interactions, as items have);
* ``lognormal``: ``min`` plus a log-normal excess read at the ranks'
  quantiles, from the head's last count down (a floor, as users have,
  under a head that falls fast).

Whole counts by largest remainder, so the sum is exact. The degrees are
the same for every seed, so every seed does the same work. The seed
decides which id holds which rank on each side, which user each item's
interactions go to, and the values, whole numbers uniform in
``[value_min, value_max]``. As in the published data no user has an
item twice: the sides are paired at random, then every pair that
repeats trades its item with an interaction of a rare item or a light
user (:func:`_distinct`), which keeps both sides' degrees, until none
repeats. Everything is drawn on the device, by the ``torch.Generator``
the run seeds, in a few large calls a round.
"""

from __future__ import annotations

import math

import torch

#: seeds are whole numbers of any size; a generator takes 63 bits
SEED_MASK = (1 << 63) - 1
#: bisection steps: far past float64's resolution
_STEPS = 200
#: rounds of trades that may pass before the pairing is given up
MAX_ROUNDS = 2000
#: candidate partners drawn a round, over all repeats
CANDIDATES = 1 << 24


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & SEED_MASK)


def _bisect(f, lo: float, hi: float) -> float:
    """The root of ``f``, below 0 at ``lo`` and above 0 at ``hi``."""
    for _ in range(_STEPS):
        mid = 0.5 * (lo + hi)
        if f(mid) < 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _zipf_mandelbrot(n: int, total: float, top: float, c_min: float,
                     device) -> torch.Tensor:
    """``n`` counts from ``top`` down to ``c_min`` summing to ``total``.
    The sum rises with ``s``: a spike as ``s → 0``, the geometric series
    from ``top`` to ``c_min`` as ``s → ∞``."""
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=device)

    def law(log_s: float) -> torch.Tensor:
        s = math.exp(log_s)
        ratio = (top / c_min) ** (1.0 / s)
        q = (n - ratio) / (ratio - 1.0)
        return top * ((1.0 + q) / (ranks + q)) ** s

    lo = math.log(math.log(top / c_min) / 700.0)  # below, ratio overflows
    return law(_bisect(lambda v: float(law(v).sum()) - total, lo,
                       math.log(1e4)))


def _lognormal(n: int, total: float, top: float, c_min: float,
               device) -> torch.Tensor:
    """``n`` counts, ``c_min`` plus a log-normal excess at the ranks'
    quantiles, ``top`` at the first, summing to ``total``. The sum falls
    as the spread ``σ`` grows."""
    r = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    z = math.sqrt(2.0) * torch.special.erfinv(1.0 - 2.0 * (r - 0.5) / n)

    def law(sigma: float) -> torch.Tensor:
        return c_min + (top - c_min) * torch.exp(sigma * (z - z[0]))

    return law(_bisect(lambda v: total - float(law(v).sum()), 1e-6, 50.0))


LAWS = {"zipf_mandelbrot": _zipf_mandelbrot, "lognormal": _lognormal}


def degrees(stats: dict, n: int, total: int, device) -> torch.Tensor:
    """One side's ``n`` interaction counts, int64, by popularity rank
    (most active first), summing to ``total``: the published ``head``,
    then ``law`` from the head's last count on."""
    head = [int(c) for c in stats["head"]]
    c_min = int(stats["min"])
    m = n - len(head) + 1  # the law's ranks, the head's last included
    rest = total - sum(head[:-1])
    if not (head and m > 1 and head == sorted(head, reverse=True)
            and 1 <= c_min < head[-1]
            and m * c_min < rest < m * head[-1]):
        raise ValueError(f"no {stats['law']} law for n={n} total={total} "
                         f"head={head} min={c_min}")
    tail = LAWS[stats["law"]](m, rest, head[-1], c_min, device)
    want = torch.cat([torch.tensor(head[:-1], dtype=torch.float64,
                                   device=device), tail])
    want = want * (total / float(want.sum()))
    counts = torch.floor(want).long()
    short = total - int(counts.sum())
    if not 0 <= short <= n:
        raise ValueError(f"the fit missed the total by {short}")
    # largest remainder: the first ``short`` rows by fractional part
    order = torch.argsort(want - counts.double(), descending=True,
                          stable=True)
    counts[order[:short]] += 1
    return counts


def _distinct(rows, cols, user_deg, item_deg, gen):
    """``cols`` with its items traded between interactions until no
    ``(rows[e], cols[e])`` pair repeats; ``user_deg[u]`` and
    ``item_deg[i]`` are the sides' counts. Each round, every repeat but
    a pair's first trades its item with an interaction drawn through a
    uniform item, or, every other round, a uniform user: mostly rare
    items and light users, which the heavy rows of repeats lack. Of a
    few such candidates the first that would make no pair that is there
    already is taken; a trade waits for a later round where none is, or
    where another trade took the same partner or makes the same pair."""
    device = cols.device
    n_items = item_deg.numel()
    by_user = torch.argsort(rows, stable=True)
    ptrs = []
    for deg in (item_deg, user_deg):
        ptr = torch.zeros(deg.numel() + 1, dtype=torch.long, device=device)
        ptr[1:] = deg.cumsum(0)
        ptrs.append(ptr)
    for rounds in range(MAX_ROUNDS):
        key, order = torch.sort(rows * n_items + cols, stable=True)
        rep = order[1:][key[1:] == key[:-1]]
        if not rep.numel():
            return cols
        m = rep.numel()
        is_rep = torch.zeros_like(rows, dtype=torch.bool)
        is_rep[rep] = True
        # ``k`` candidates a repeat; the first that makes no pair that is
        # there already, and is no repeat itself, is its partner
        k = max(1, min(CANDIDATES // m, 64))
        deg, ptr = (item_deg, user_deg)[rounds % 2], ptrs[rounds % 2]
        grouped = (torch.argsort(cols, stable=True) if rounds % 2 == 0
                   else by_user)
        j = torch.randint(0, deg.numel(), (m, k), generator=gen,
                          device=device)
        off = (torch.rand((m, k), generator=gen, device=device,
                          dtype=torch.float64) * deg[j]).long()
        cand = grouped[ptr[j] + off]
        new = torch.stack([rows[rep, None] * n_items + cols[cand],
                           rows[cand] * n_items + cols[rep, None]])
        at = torch.searchsorted(key, new).clamp_(max=key.numel() - 1)
        ok = (key[at] != new).all(0) & ~is_rep[cand]
        pick = ok.int().argmax(1)
        keep = ok.any(1)
        a = rep[keep]
        b = cand[keep, pick[keep]]
        new = new[:, keep, pick[keep]]
        # one trade a partner, and no two trades that make one pair:
        # each round only removes repeats
        _, inv, count = torch.unique(b, return_inverse=True,
                                     return_counts=True)
        once = count[inv] == 1
        _, inv, count = torch.unique(new.reshape(-1), return_inverse=True,
                                     return_counts=True)
        once &= (count[inv] == 1).reshape(2, -1).all(0)
        a, b = a[once], b[once]
        cols[a], cols[b] = cols[b], cols[a].clone()
    raise ValueError(f"pairs still repeat after {MAX_ROUNDS} rounds")


def interactions(config: dict, gen: torch.Generator, traffic: dict,
                 device):
    """``(rows int32 [nnz], cols int32 [nnz], vals float32 [nnz])`` as
    host numpy arrays: ``config``'s ``n_users`` users and ``n_items``
    items with degrees from its ``degrees``, values from ``traffic``'s
    ``value_min`` and ``value_max``."""
    nu, ni = int(config["n_users"]), int(config["n_items"])
    nnz = int(config["n_interactions"])
    du = degrees(config["degrees"]["users"], nu, nnz, device)
    di = degrees(config["degrees"]["items"], ni, nnz, device)
    users = torch.randperm(nu, generator=gen, device=device)
    items = torch.randperm(ni, generator=gen, device=device)
    rows = torch.repeat_interleave(users, du)
    cols = torch.repeat_interleave(items, di)
    cols = cols[torch.randperm(nnz, generator=gen, device=device)]
    user_deg, item_deg = torch.empty_like(du), torch.empty_like(di)
    user_deg[users], item_deg[items] = du, di
    cols = _distinct(rows, cols, user_deg, item_deg, gen)
    vals = torch.randint(int(traffic["value_min"]),
                         int(traffic["value_max"]) + 1, (nnz,),
                         generator=gen, device=device)
    return (rows.int().cpu().numpy(), cols.int().cpu().numpy(),
            vals.float().cpu().numpy())
