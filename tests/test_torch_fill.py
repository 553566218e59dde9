"""The port's batched progressive fill (``repro_torch.sweep.vmap_fill`` and
``repro_torch.kernels.fill``) against the JAX package's scalar reference
``repro.sweep.vmap_fill.fill_reference``, on the CPU: fill problems
captured from the JAX simulator give the same rates and ``dt_next`` bit for
bit through the port's ``fill_reference``, through ``fill_rates_dt_ref``
(``PackedProblems`` and ``BatchedFillSolver(device="cpu")``), whatever
else shares the batch and however it is padded. (The JAX package's batched
kernel needs ``enable_x64``, which its JAX build lacks, so its scalar
reference is the fixed point: the JAX tests hold that one bit-identical to
the live allocator.)"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sweep import vmap_fill as jvf  # noqa: E402
from repro_torch.kernels import fill as fk  # noqa: E402
from repro_torch.sweep import vmap_fill as vf  # noqa: E402

#: (algo, scenario, n_jobs, hosts_per_pod, limit): the JAX package's own
#: corpus cell, and a 4-pod cell whose fills cross the INLINE_C routing
CELLS = {
    "joss-t/oversub8/8x2": ("joss-t", "oversub8", 12, (8, 8), 256),
    "fifo/oversub24/8x4": ("fifo", "oversub24", 16, (8,) * 4, 400),
}


@pytest.fixture(scope="module", params=sorted(CELLS))
def cell(request):
    algo, scen, n_jobs, hosts, limit = CELLS[request.param]
    snaps = jvf.contention_snapshots(algo, scen, n_jobs=n_jobs,
                                     hosts_per_pod=hosts, limit=limit)
    assert len(snaps) >= 100
    ref = jvf.batched_fill_reference(snaps)
    return request.param, snaps, ref


def _problem(snapshot):
    """A ``fill_problem()``-shaped dict from a snapshot (the packing the
    fabric does, with ``remaining = target - vdone``)."""
    p = jvf.PackedProblems([snapshot])
    C = max(1, len(snapshot["classes"]))
    L = max(1, len(snapshot["links"]))
    return {"caps": p.caps[0, :L], "members": p.members[0, :C, :L],
            "n": p.n[0, :C], "fcap": p.fcap[0, :C],
            "cap_rank": p.cap_rank[0, :C],
            "remaining": p.target[0, :C] - p.vdone[0, :C]}


def _packed_args(p, pad_c=0, pad_l=0):
    """The kernel's inputs from a ``PackedProblems``, optionally with
    ``pad_c`` more classes and ``pad_l`` more links of padding."""
    S, C, L = p.members.shape
    caps = np.full((S, L + pad_l), np.inf)
    caps[:, :L] = p.caps
    members = np.zeros((S, C + pad_c, L + pad_l), np.uint8)
    members[:, :C, :L] = p.members
    vecs = []
    for a, fill in ((p.n, 0.0), (p.fcap, np.inf),
                    (p.cap_rank, float(C + pad_c)),
                    (p.target - p.vdone, np.inf)):
        v = np.full((S, C + pad_c), fill)
        v[:, :C] = a
        vecs.append(v)
    return [torch.from_numpy(a) for a in (caps, members, *vecs)]


def test_port_captures_the_jax_corpus(cell):
    """The port's simulator records the very fill problems the JAX
    package's does (capture seam, cell seeds, trajectories)."""
    name, snaps, _ = cell
    algo, scen, n_jobs, hosts, limit = CELLS[name]
    assert vf.contention_snapshots(algo, scen, n_jobs=n_jobs,
                                   hosts_per_pod=hosts,
                                   limit=limit) == snaps


def test_reference_bit_equal_to_jax_reference_and_allocator(cell):
    _, snaps, _ = cell
    for snap in snaps:
        got = vf.fill_reference(snap)
        assert got == jvf.fill_reference(snap)
        assert got["rates"] == [c["rate"] for c in snap["classes"]]


def test_plain_torch_fill_bit_equal(cell):
    _, snaps, ref = cell
    p = vf.PackedProblems(snaps)
    rates, dt = fk.fill_rates_dt_ref(*_packed_args(p))
    assert np.array_equal(rates.numpy(), ref["rates"])
    assert np.array_equal(dt.numpy(), ref["dt_next"])
    out = vf.batched_fill(snaps, device="cpu")
    assert np.array_equal(out["rates"], ref["rates"])
    assert np.array_equal(out["dt_next"], ref["dt_next"])
    for i in range(len(snaps)):
        assert vf.orderings_match(ref["etas"][i], out["etas"][i])


def test_cpu_solver_bit_equal(cell):
    _, snaps, ref = cell
    with vf.BatchedFillSolver(device="cpu") as solver:
        sols = solver.solve([_problem(s) for s in snaps])
    assert len(sols) == len(snaps) and solver.n_batches == 1
    for i, (snap, (rates, dt)) in enumerate(zip(snaps, sols)):
        c = len(snap["classes"])
        assert isinstance(rates, np.ndarray) and rates.dtype == np.float64
        assert isinstance(dt, float)
        assert np.array_equal(rates, ref["rates"][i, :max(1, c)])
        assert dt == ref["dt_next"][i]


def test_solver_copies_the_problem_arrays(cell):
    """The fabric reuses its arrays between calls: a later edit of a
    problem's arrays must not reach a solve that already returned, and
    the solver's buffers must not alias them."""
    _, snaps, ref = cell
    probs = [_problem(s) for s in snaps[:8]]
    solver = vf.BatchedFillSolver(device="cpu")
    first = solver.solve(probs)
    for p in probs:
        p["caps"][:] = 1.0
    again = solver.solve([_problem(s) for s in snaps[:8]])
    for (r0, d0), (r1, d1) in zip(first, again):
        assert np.array_equal(r0, r1) and d0 == d1


def test_batch_composition_and_padding_are_inert(cell):
    """A problem's row does not depend on what shares its batch or how
    far the batch is padded beyond it."""
    _, snaps, ref = cell
    sizes = {len(s["classes"]) for s in snaps}
    assert len(sizes) > 1, "corpus is uniform; padding untested"
    picks = (0, len(snaps) // 2, len(snaps) - 1)
    for i in picks:
        for pad_c, pad_l in ((0, 0), (37, 0), (5, 11)):
            p = vf.PackedProblems([snaps[i]])
            rates, dt = fk.fill_rates_dt_ref(*_packed_args(p, pad_c, pad_l))
            c = max(1, len(snaps[i]["classes"]))
            assert np.array_equal(rates[0, :c].numpy(), ref["rates"][i, :c])
            assert np.all(rates[0, c:].numpy() == 0.0)
            assert dt.item() == ref["dt_next"][i]
    solver = vf.BatchedFillSolver(device="cpu")
    mixed = solver.solve([_problem(snaps[i]) for i in reversed(picks)])
    for (rates, dt), i in zip(mixed, reversed(picks)):
        assert np.array_equal(rates, ref["rates"][i, :len(rates)])
        assert dt == ref["dt_next"][i]


def _single_flow_snap():
    return {"links": [["wan", 0, 6.0]],
            "classes": [{"path": [["wan", 0]], "cap": 100.0, "n": 1,
                         "vdone": 1.0, "target": 4.0}]}


def _all_capped_snap():
    return {"links": [["wan", 0, 100.0]],
            "classes": [{"path": [["wan", 0]], "cap": 2.0, "n": 2,
                         "vdone": 0.0, "target": 8.0},
                        {"path": [["wan", 0]], "cap": 3.0, "n": 1,
                         "vdone": 1.0, "target": None}]}


DEGENERATE = {
    "zero_class": {"links": [["wan", 0, 10.0]], "classes": []},
    "single_flow": _single_flow_snap(),
    "all_capped": _all_capped_snap(),
    "even_split": {"links": [["wan", 0, 10.0]],
                   "classes": [{"path": [["wan", 0]], "cap": 100.0,
                                "n": 1, "vdone": 0.0, "target": 5.0},
                               {"path": [["wan", 0]], "cap": 100.0,
                                "n": 1, "vdone": 2.5, "target": 5.0}]},
    "cap_beats_link": {"links": [["wan", 0, 10.0]],
                       "classes": [{"path": [["wan", 0]], "cap": 2.0,
                                    "n": 1, "vdone": 0.0, "target": 4.0},
                                   {"path": [["wan", 0]], "cap": 100.0,
                                    "n": 1, "vdone": 0.0,
                                    "target": None}]},
    # equal caps on a shared link, where debiting both at once would
    # round the third class's share differently (test below)
    "equal_caps_collapse": {
        "links": [["down", 0, 1e6], ["wan", 0, 29.37]],
        "classes": [{"path": [["down", 0], ["wan", 0]], "cap": 1.667,
                     "n": 4, "vdone": 0.0, "target": 3.0},
                    {"path": [["wan", 0]], "cap": 1.667, "n": 4,
                     "vdone": 0.0, "target": 2.0},
                    {"path": [["wan", 0]], "cap": 1000.0, "n": 3,
                     "vdone": 0.0, "target": 9.0}]},
    # equal caps on one link, the allocator's one-cap-a-round order
    "equal_caps_shared_link": {
        "links": [["down", 0, 7.3], ["wan", 0, 9.1]],
        "classes": [{"path": [["down", 0], ["wan", 0]], "cap": 1.7,
                     "n": 2, "vdone": 0.0, "target": 3.0},
                    {"path": [["wan", 0]], "cap": 1.7, "n": 1,
                     "vdone": 0.5, "target": 2.0},
                    {"path": [["down", 0]], "cap": 50.0, "n": 3,
                     "vdone": 0.0, "target": 9.0}]},
}


@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_degenerate_snapshots_bit_equal(name):
    snap = DEGENERATE[name]
    want = jvf.batched_fill_reference([snap])
    alone = vf.batched_fill([snap], device="cpu")
    assert np.array_equal(alone["rates"], want["rates"])
    assert np.array_equal(alone["dt_next"], want["dt_next"])
    # and inside one mixed batch with every other degenerate snapshot
    snaps = [DEGENERATE[k] for k in sorted(DEGENERATE)]
    mixed = vf.batched_fill(snaps, device="cpu")
    i = sorted(DEGENERATE).index(name)
    c = want["rates"].shape[1]
    assert np.array_equal(mixed["rates"][i, :c], want["rates"][0])
    assert mixed["dt_next"][i] == want["dt_next"][0]


def test_equal_caps_take_one_round_each():
    """Two classes capped at the same rate on one link are fixed on two
    rounds, each debiting the link on its own, as the scalar allocator
    does; one combined debit (the JAX kernel's collapse of the two
    rounds) rounds the last class's share differently."""
    snap = DEGENERATE["equal_caps_collapse"]
    r, rem = 1.667, 29.37
    chained = max(0.0, max(0.0, rem - 4 * r) - 4 * r) / 3
    combined = max(0.0, rem - 8 * r) / 3
    assert chained != combined
    want = [r, r, chained]
    assert jvf.fill_reference(snap)["rates"] == want
    out = vf.batched_fill([snap], device="cpu")
    assert out["rates"][0].tolist() == want


def test_zero_class_row_is_inert():
    out = vf.batched_fill([DEGENERATE["zero_class"]], device="cpu")
    assert np.all(out["rates"] == 0.0)
    assert np.all(np.isinf(out["etas"])) and np.all(np.isinf(
        out["dt_next"]))


def test_empty_batch():
    out = vf.batched_fill([], device="cpu")
    assert out["rates"].shape[0] == 0 and out["dt_next"].shape == (0,)
    assert vf.BatchedFillSolver(device="cpu").solve([]) == []
    p = vf.PackedProblems([])
    assert p.caps.shape == (0, 1) and p.members.shape == (0, 1, 1)


def test_copied_helpers_match_jax():
    assert vf.RTOL == jvf.RTOL
    a = np.array([1.0, 2.0, np.inf, 2.0 * (1 + 1e-12)])
    b = np.array([1.0, 2.0 * (1 + 1e-12), np.inf, 2.0])
    for x, y in ((a, b), (a, a[::-1].copy()), (a, a[:3])):
        assert vf.orderings_match(x, y) == jvf.orderings_match(x, y)


def test_kernel_wrapper_checks_and_refusals():
    """The wrapper runs the plain version only for CPU tensors; a
    solver on the default device needs CUDA; the kernel's status flags
    become a raise; bad inputs are refused before any launch."""
    p = vf.PackedProblems([_all_capped_snap()])
    args = _packed_args(p)
    assert fk.fill_rates_dt(*args)[0].tolist() == [[2.0, 3.0]]
    with pytest.raises(ValueError, match="no fill kernel"):
        fk.fill_rates_dt(*[a.to("meta") for a in args])
    with pytest.raises(TypeError, match="uint8"):
        fk._check([args[0], args[1].double(), *args[2:]])
    with pytest.raises(ValueError, match="must be"):
        fk._check([args[0][:, :0], *args[1:]])
    with pytest.raises(RuntimeError, match="no progress"):
        fk.raise_on_status(np.array([0.0, 1.0]))
    fk.raise_on_status(np.zeros(3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vf.BatchedFillSolver()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vf.batched_fill([_all_capped_snap()])


def test_build_load_sets_signatures_named_after_first_load(tmp_path,
                                                           monkeypatch):
    """A library first loaded without a function's signature gets it on the
    first call that names it: ctypes would otherwise pass that function's
    pointer arguments as 32-bit ints."""
    import ctypes

    from repro_torch.kernels import build

    class _Fn:
        argtypes = None
        restype = None

    class _Lib:
        def __init__(self, path):
            self.repro_cuda_error_string = _Fn()
            self.repro_fill_rates_dt = _Fn()

    lib_path = tmp_path / "libfill-fake.so"
    lib_path.write_bytes(b"")
    monkeypatch.setattr(build, "library_path", lambda name: lib_path)
    monkeypatch.setattr(build.ctypes, "CDLL", _Lib)
    monkeypatch.setattr(build, "_loaded", {})
    lib = build.load("fill")
    assert lib.repro_cuda_error_string.argtypes == [ctypes.c_int]
    assert lib.repro_fill_rates_dt.argtypes is None
    assert build.load("fill", fk._SIGNATURES) is lib
    restype, argtypes = fk._SIGNATURES["repro_fill_rates_dt"]
    assert lib.repro_fill_rates_dt.argtypes == argtypes
    assert lib.repro_fill_rates_dt.restype is restype
