"""The fill kernel's two variants (``repro_torch.kernels.fill``): which one a
shape goes to, what ``launch`` refuses, and the register kernel's round,
all on the CPU.

``_reg_fill`` transcribes the round of ``fill_reg_kernel``
(csrc/fill.cu) in Python floats: class masks of each link as Python ints,
the live classes presorted by (cap_rank, index) and the next cap the least
place of an unfixed one, sums of n as popcounts against bit planes of n
(or class by class where n is not whole), shares cached and recomputed
only on the links a round debits (k_l > 0). It is held bit for bit against the JAX package's scalar
reference ``repro.sweep.vmap_fill.fill_reference`` on the corpora of
tests/test_torch_fill.py and on the boundary corpora ``chip_smoke.py``
runs on the card (class and link counts at the edges of the kernel's
templates, a class on every link, a link crossed by every class, equal
caps, a padded row, and ranks that tie and are not integers), on which the
plain version ``fill_rates_dt_ref`` is held to the same reference."""
import itertools
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro.sweep import vmap_fill as jvf  # noqa: E402
from repro_torch.kernels import fill as fk  # noqa: E402
from repro_torch.sweep import vmap_fill as vf  # noqa: E402
from test_torch_fill import CELLS, DEGENERATE  # noqa: E402


def _bits(x):
    """Set bits of a Python int, lowest first (``__ffsll`` order)."""
    while x:
        low = x & -x
        yield low.bit_length() - 1
        x ^= low


def _sum_n(x, nn, planes):
    """The sum of n over the classes of the set x: popcounts against the
    bit planes of n where every n is a whole number in [0, 2^16), else n a
    class at a time in class order."""
    if planes is not None:
        return float(sum(bin(x & p).count("1") << b
                         for b, p in enumerate(planes)))
    d = 0.0
    for c in _bits(x):
        d += nn[c]
    return d


def _reg_fill(caps, members, n, fcap, cap_rank, remaining):
    """(rates (S, C), dt (S,)) by the register kernel's round."""
    S, C, L = members.shape
    rates = np.zeros((S, C))
    dt = np.full(S, math.inf)
    for s in range(S):
        nn = [float(x) for x in n[s]]
        live = [c for c in range(C) if nn[c] > 0.0]
        planes = None
        if all(0.0 <= x < 2 ** 16 and x == int(x) for x in nn):
            planes = [sum(1 << c for c in range(C) if int(nn[c]) >> b & 1)
                      for b in range(int(max(nn)).bit_length())]
        mask = [sum(1 << c for c in range(C) if members[s, c, l])
                for l in range(L)]
        rem = [float(x) for x in caps[s]]
        nuse = [_sum_n(m, nn, planes) for m in mask]
        share = [rem[l] / nuse[l] if nuse[l] > 0.0 else None
                 for l in range(L)]
        # each live class's place in the cap order
        order = sorted(live, key=lambda c: (float(cap_rank[s, c]), c))
        place = {c: i for i, c in enumerate(order)}
        fixed = ((1 << C) - 1) & ~sum(1 << c for c in live)
        for rnd in itertools.count():
            todo = [place[c] for c in live if not fixed >> c & 1]
            if not todo:
                break
            assert rnd < len(live), "more rounds than classes"
            bc = order[min(todo)]
            cands = [(share[l], l) for l in range(L) if share[l] is not None]
            li = min(cands)[1] if cands else None
            cap = float(fcap[s, bc])
            cap_wins = li is None or cap < share[li]
            sh = cap if cap_wins else share[li]
            newly = 1 << bc if cap_wins else mask[li] & ~fixed
            assert newly, "a round fixed no class"
            fixed |= newly
            for c in _bits(newly):
                rates[s, c] = sh
            for l in range(L):
                d = _sum_n(newly & mask[l], nn, planes)
                if d > 0.0:
                    x = rem[l] - d * sh
                    rem[l] = x if x > 0.0 else 0.0
                    nuse[l] -= d
                    share[l] = rem[l] / nuse[l] if nuse[l] > 0.0 else None
        etas = [float(remaining[s, c]) / rates[s, c] for c in range(C)
                if rates[s, c] > 0.0 and math.isfinite(remaining[s, c])]
        dt[s] = min(etas, default=math.inf)
    return rates, dt


def _arrays(snaps, ranks=None):
    p = vf.PackedProblems(snaps)
    rank = p.cap_rank if ranks is None else ranks(p)
    return p, [p.caps, p.members.astype(np.uint8), p.n, p.fcap, rank,
               p.target - p.vdone]


def _tied(p):
    return cs.tied_ranks(p.cap_rank, p.n, seed=7)


BOUNDARY = cs.fill_boundary_corpora()


@pytest.mark.parametrize("C,L,want", [
    (64, 32, "reg"), (65, 32, "reg"), (128, 32, "reg"), (129, 32, "reg"),
    (256, 32, "reg"), (257, 32, "smem"), (1, 1, "reg"),
    (64, 33, "reg"), (64, 64, "reg"), (64, 65, "reg"), (64, 128, "reg"),
    (64, 129, "smem"), (256, 128, "reg"), (257, 129, "smem")])
def test_choose_variant_edges(C, L, want):
    assert fk.choose_variant(C, L) == want


def test_launch_refuses_reg_past_its_template_and_unknown_variants():
    """Refused before any build or launch, on any device."""
    def args(C, L):
        return [torch.zeros((1, L), dtype=torch.float64),
                torch.zeros((1, C, L), dtype=torch.uint8),
                *[torch.zeros((1, C), dtype=torch.float64)
                  for _ in range(4)]]

    for C, L in ((257, 4), (4, 129)):
        a = args(C, L)
        out = torch.empty(C + 2, dtype=torch.float64)
        with pytest.raises(ValueError, match="reg kernel holds at most"):
            fk.launch(*a, out, variant="reg")
        with pytest.raises(ValueError, match="reg kernel holds at most"):
            fk.fill_rates_dt(*a, variant="reg")
    a = args(4, 4)
    with pytest.raises(ValueError, match="not in"):
        fk.launch(*a, torch.empty(6, dtype=torch.float64), variant="tc")
    with pytest.raises(ValueError, match="not in"):
        fk.fill_rates_dt(*a, variant="tc")
    with pytest.raises(ValueError, match="no fill kernel for device cpu"):
        fk.launch(*a, torch.empty(6, dtype=torch.float64), variant="smem")
    assert set(fk.fill_rates_dt.launches_by_variant) == set(fk.VARIANTS)


def test_boundary_corpora_have_their_features():
    shapes = {tuple(vf.PackedProblems(s).members.shape[1:])
              for s in BOUNDARY.values()}
    assert shapes == {*itertools.product(cs.FILL_BOUNDARY_C,
                                         cs.FILL_BOUNDARY_L),
                      cs.FILL_BOUNDARY_TOP}
    for snaps in BOUNDARY.values():
        rand, full, ties, padded = snaps
        n_links = len(full["links"])
        assert len(full["classes"][0]["path"]) == n_links
        assert all(["l", 0] in c["path"] for c in full["classes"])
        assert len({c["cap"] for c in ties["classes"]}) == 1
        assert len({cap for _, _, cap in ties["links"]}) == 1
        assert len(padded["classes"]) < len(rand["classes"])
        assert len(padded["links"]) < len(rand["links"])
        p, _ = _arrays(snaps)
        rank = _tied(p)
        live = p.n > 0
        assert np.any(rank[live] != np.round(rank[live]))
        assert any(len(set(rank[r][live[r]])) < live[r].sum()
                   for r in range(len(snaps)))


@pytest.mark.parametrize("ranks", ["packed", "tied"])
@pytest.mark.parametrize("name", sorted(BOUNDARY))
def test_boundary_corpus_bit_equal_to_reference(name, ranks):
    """The plain version and the register kernel's round, against the
    JAX package's scalar reference; tied ranks keep the order, so the
    answers stay the reference's."""
    snaps = BOUNDARY[name]
    ref = jvf.batched_fill_reference(snaps)
    _, a = _arrays(snaps, _tied if ranks == "tied" else None)
    rates, dt = fk.fill_rates_dt_ref(*[torch.from_numpy(
        np.ascontiguousarray(x)) for x in a])
    assert np.array_equal(rates.numpy(), ref["rates"])
    assert np.array_equal(dt.numpy(), ref["dt_next"])
    r_rates, r_dt = _reg_fill(*a)
    assert np.array_equal(r_rates, ref["rates"])
    assert np.array_equal(r_dt, ref["dt_next"])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_reg_round_bit_equal_on_captured_corpus(name):
    algo, scen, n_jobs, hosts, limit = CELLS[name]
    snaps = jvf.contention_snapshots(algo, scen, n_jobs=n_jobs,
                                     hosts_per_pod=hosts, limit=limit)
    ref = jvf.batched_fill_reference(snaps)
    rates, dt = _reg_fill(*_arrays(snaps)[1])
    assert np.array_equal(rates, ref["rates"])
    assert np.array_equal(dt, ref["dt_next"])


@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_reg_round_bit_equal_on_degenerate(name):
    ref = jvf.batched_fill_reference([DEGENERATE[name]])
    rates, dt = _reg_fill(*_arrays([DEGENERATE[name]])[1])
    assert np.array_equal(rates, ref["rates"])
    assert np.array_equal(dt, ref["dt_next"])


@pytest.mark.parametrize("name", sorted(BOUNDARY))
def test_boundary_corpus_half_n(name):
    """n halved: no longer whole, so the sums go class by class in class
    order; halves add exactly, so the plain version's sums agree."""
    p, a = _arrays(BOUNDARY[name])
    a[2] = p.n * 0.5
    rates, dt = fk.fill_rates_dt_ref(*[torch.from_numpy(
        np.ascontiguousarray(x)) for x in a])
    r_rates, r_dt = _reg_fill(*a)
    assert np.array_equal(r_rates, rates.numpy())
    assert np.array_equal(r_dt, dt.numpy())
