"""B7's step loop (nomad_tpu_torch/csrc/preempt.cu ``nt_preempt_solve``)
on the CPU: its schedule in plain torch, and its host call on stub cards.

The kernel cannot run here (no ``nvcc``, no card), so this module keeps a
plain-torch model of what one launch does. The set-up pass copies the
carry (used, ev = the eligible victim vectors' sum), zeroes a
claimed-prefix pointer a node, scores every node once and caches its order
key, ``desc_key(score) << 32 | index`` (csrc/sort.cuh; the smallest key is
``jnp.argmax``'s first maximum), reduced into a two-level tree: one
minimum a 32-node segment, then the minimum over the segments. Each step
(warp 0 alone on the card) reads the top; stops at the first step whose
best score is NEG, writing -1 / NEG / no victims for it and every later
step; skips an inactive step; else scans the chosen node's columns from
its pointer 32 at a time (a prefix sum a dim, as the warp's shuffles
form it) while the exclusive prefix is below the deficit in some dim with
a deficit (the evicted vector is the prefix at the last victim), commits
that node's carry row, moves its pointer past its last victim, rescores
it and refreshes its segment and the top.

The model must equal ``preempt_solve_ref`` bit for bit and the JAX
package's ``preempt_solve`` (picks, victims and flags exactly, live scores
within ``SCORE_RTOL``: torch's and XLA's f32 ``10**x`` and ``exp`` may
round 1 ulp apart) on tests/test_torch_preempt.py's fixtures and on
N 1, N 33, N 1,000 (ragged segments) and a fixture whose every node goes
NEG mid-run. At every step the cached keys equal a full rescore's, the
tree's top is the full argmax, and the pointers are the reference's taken
bits (every eligible column below a node's pointer is claimed, none
above)."""

import jax
import numpy as np
import pytest
import torch

from nomad_tpu.tensor import kernels as ref_kernels
from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import kernels
from nomad_tpu_torch.tensor.kernels import (NEG, _preempt_scores,
                                            preempt_score_ref,
                                            preempt_solve_ref)
from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)
from test_torch_preempt import (EDGES, SCORE_RTOL, SEEDS, _net_prio,
                                edge_problem, random_victim_problem)

LANES = 32      # a segment of the tree, a chunk of the victim scan
MASK32 = 0xFFFFFFFF
NO_KEY = torch.iinfo(torch.int64).max


def order_keys(score: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit order keys as int64 (its top bit flipped, so
    int64 order is the kernel's uint64 order): desc_key(score) above the
    node index."""
    b = score.view(torch.int32).to(torch.int64) & MASK32
    b = torch.where(b == 0x80000000, 0, b)            # -0.0 with +0.0
    ordered = torch.where(b >= 0x80000000, ~b & MASK32, b | 0x80000000)
    desc = ~ordered & MASK32
    return ((desc - 0x80000000) << 32) | index


def key_score(key: int) -> float:
    """The score a key holds: desc_key inverted."""
    ordered = ~((key >> 32) + 0x80000000) & MASK32
    bits = ordered & 0x7FFFFFFF if ordered & 0x80000000 else ~ordered & MASK32
    return float(np.array(bits, np.uint32).view(np.float32))


def tree(keys: torch.Tensor) -> torch.Tensor:
    """The segment minima of the keys, 32 nodes a segment."""
    n = keys.shape[0]
    pad = torch.full((-(-n // LANES) * LANES,), NO_KEY, dtype=torch.int64)
    pad[:n] = keys
    return pad.reshape(-1, LANES).min(dim=1).values


class Loop:
    """One nt_preempt_solve launch in plain torch. With ``checked`` the
    cache and the pointers are held, after the set-up pass and after every
    step, against the reference's state: the keys against a full rescore,
    the top against the full argmax, the pointers against the taken bits
    (kept beside the model for that alone)."""

    def __init__(self, available, used0, ask, feasible, net_prio, active,
                 v_prio, v_vec, v_elig, v_flag, checked=False):
        f = available.dtype
        self.a, self.ask, self.feasible = available, ask, feasible
        self.v_vec, self.v_elig, self.v_flag = v_vec, v_elig, v_flag
        self.active = active
        self.pscore = preempt_score_ref(net_prio)
        self.n, self.v = v_elig.shape
        self.used = used0.clone()
        self.ev = torch.sum(v_vec * v_elig[:, :, None].to(f), dim=1)
        self.ptr = torch.zeros(self.n, dtype=torch.int64)
        score, _, _ = _preempt_scores(available, self.used, ask, feasible,
                                      self.ev, self.pscore)
        self.keys = order_keys(score, torch.arange(self.n))
        self.seg = tree(self.keys)
        self.checked = checked
        self.taken = torch.zeros_like(v_elig)
        self.checks = 0

    def rescore(self, b: int) -> int:
        r = slice(b, b + 1)
        score, _, _ = _preempt_scores(self.a[r], self.used[r], self.ask,
                                      self.feasible[r], self.ev[r],
                                      self.pscore[r])
        return int(order_keys(score, torch.tensor([b]))[0])

    def scan(self, b: int, deficit: torch.Tensor):
        """The chosen node's victims, 32 columns at a time from its
        pointer: (selected columns, evicted vector, flag)."""
        carry = torch.zeros_like(deficit)
        evicted = torch.zeros_like(deficit)
        owed = deficit > 0.0
        chosen, flag = [], False
        base = int(self.ptr[b])
        while base < self.v:
            cols = torch.arange(base, min(base + LANES, self.v))
            row = self.v_elig[b, cols]
            x = self.v_vec[b, cols] * row[:, None].to(deficit.dtype)
            incl = torch.cumsum(x, dim=0)
            before = carry[None, :] + (incl - x)
            sel = row & torch.any(owed[None, :] & (before < deficit), dim=1)
            chosen += cols[sel].tolist()
            flag = flag or bool(torch.any(self.v_flag[b, cols] & sel))
            if bool(sel.any()):
                # a prefix of the eligible columns: the prefix sum at its
                # last one is its sum
                top = int(torch.nonzero(sel).max())
                assert bool(sel[:top + 1].eq(row[:top + 1]).all())
                evicted = carry + incl[top]
            carry = carry + incl[-1]
            covered = not bool(torch.any(owed & (carry < deficit)))
            if covered or bool(torch.any(row & ~sel)):
                break
            base += LANES
        return chosen, evicted, flag

    def verify(self) -> None:
        score, _, _ = _preempt_scores(self.a, self.used, self.ask,
                                      self.feasible, self.ev, self.pscore)
        assert torch.equal(self.keys,
                           order_keys(score, torch.arange(self.n)))
        assert torch.equal(self.seg, tree(self.keys))
        top = int(self.seg.min())
        assert top & MASK32 == int(torch.argmax(score))
        assert key_score(top) == float(score.max())
        below = torch.arange(self.v)[None, :] < self.ptr[:, None]
        assert torch.equal(self.taken, self.v_elig & below)
        self.checks += 1

    def run(self):
        k = self.active.shape[0]
        picks = torch.full((k,), -1, dtype=torch.int32)
        victims = torch.zeros((k, self.v), dtype=torch.bool)
        flagged = torch.zeros(k, dtype=torch.bool)
        scores = torch.full((k,), NEG, dtype=torch.float32)
        if self.checked:
            self.verify()
        self.exit_step = k
        for step in range(k):
            top = int(self.seg.min())
            best = key_score(top)
            if not best > NEG:
                self.exit_step = step   # the rest: -1, NEG, no victims
                break
            if not bool(self.active[step]):
                continue
            b = top & MASK32
            nu = self.used[b] + self.ask
            deficit = torch.clamp_min(nu - self.a[b], 0.0)
            evicted = torch.zeros_like(deficit)
            if bool(torch.any(deficit > 0.0)):
                chosen, evicted, flag = self.scan(b, deficit)
                victims[step, chosen] = True
                flagged[step] = flag
                if chosen:
                    self.ptr[b] = chosen[-1] + 1
            picks[step] = b
            scores[step] = best
            self.used[b] = torch.clamp_min(nu - evicted, 0.0)
            self.ev[b] = torch.clamp_min(self.ev[b] - evicted, 0.0)
            self.keys[b] = self.rescore(b)
            s = b // LANES
            self.seg[s] = self.keys[s * LANES:(s + 1) * LANES].min()
            self.taken[b] |= victims[step]
            if self.checked:
                self.verify()
        return picks, victims, flagged, scores


def model(args, checked=True):
    """The model's loop and outputs on numpy ``args`` (preempt_solve's
    order)."""
    loop = Loop(*(torch.from_numpy(np.asarray(a)) for a in args),
                checked=checked)
    return loop, loop.run()


def _jax_solve(args):
    out = jax.device_get(ref_kernels.preempt_solve(*jax.device_put(args)))
    return [np.asarray(x) for x in out]


def ragged_problem(n, k=16, v=8, d=3, seed=3):
    """tests/test_torch_preempt.py's random problem at another node
    count: N 1, 33 and 1,000 leave the last segment of the tree part
    empty."""
    return random_victim_problem(seed, n=n, k=k, v=v, d=d)


def all_neg_problem(n=40, k=96, v=8, d=3):
    """Every node full, with two victims of half the ask's size each and
    no room: a node takes one request a victim pair... until its victims
    run out, then goes NEG. 40 nodes x 1 request each (each request
    evicts both victims) leave steps 40-95 to the early exit; steps 5 and
    41 are inactive."""
    available = np.full((n, d), 4000, np.float32)
    used = available.copy()
    ask = np.array([1000, 800, 10], np.float32)
    feasible = np.ones(n, bool)
    active = np.ones(k, bool)
    active[[5, 41]] = False
    v_prio = np.zeros((n, v), np.float32)
    v_vec = np.zeros((n, v, d), np.float32)
    v_elig = np.zeros((n, v), bool)
    v_flag = np.zeros((n, v), bool)
    v_prio[:, :2] = (10, 20)
    v_vec[:, :2] = (500, 400, 5)
    v_elig[:, :2] = True
    v_flag[::7, 1] = True
    rng = np.random.default_rng(11)
    available[:, 0] += rng.integers(0, 3, n) * 100     # unequal scores
    used[:, 0] = available[:, 0]
    return (available, used, ask, feasible, _net_prio(v_prio), active,
            v_prio, v_vec, v_elig, v_flag)


FIXTURES = ([(f"seed{s}", lambda s=s: random_victim_problem(s))
             for s in SEEDS]
            + [(e, lambda e=e: edge_problem(e)) for e in EDGES]
            + [(f"n{n}", lambda n=n: ragged_problem(n))
               for n in (1, 33, 1000)]
            + [("allneg", all_neg_problem)])


@pytest.mark.parametrize("name,make", FIXTURES, ids=[f for f, _ in FIXTURES])
def test_loop_equals_plain_and_jax(name, make):
    args = make()
    loop, got = model(args, checked=args[0].shape[0] <= 64)
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    want = preempt_solve_ref(*t)
    for what, x, y in zip(("picks", "victims", "flagged", "scores"), got,
                          want):
        assert torch.equal(x, y), f"{name}: {what}"
    jx = _jax_solve(args)
    for what, x, y in zip(("picks", "victims", "flagged"), got, jx):
        np.testing.assert_array_equal(x.numpy(), y, err_msg=f"{name}: {what}")
    live = jx[0] >= 0
    np.testing.assert_allclose(got[3].numpy()[live], jx[3][live],
                               rtol=SCORE_RTOL, err_msg=f"{name}: scores")
    assert (got[3].numpy()[~live] == np.float32(NEG)).all()
    if loop.checked:
        assert loop.checks == 1 + int((got[0] >= 0).sum())


def test_loop_invariants_at_1000_nodes():
    """The ragged 1,000-node fixture with the invariants held at every
    step (the full rescore a step is the plain version's cost)."""
    loop, got = model(ragged_problem(1000, k=12))
    assert loop.checks == 1 + int((got[0] >= 0).sum()) > 1
    assert loop.seg.shape == (32,)


def test_every_node_goes_neg_mid_run():
    """The all-NEG fixture exits early: the first NEG step is the one
    after every node has spent its victims, and from there every step is
    -1, NEG, no victims."""
    args = all_neg_problem()
    loop, (picks, victims, flagged, scores) = model(args)
    n, k = args[0].shape[0], args[5].shape[0]
    placed = int((picks >= 0).sum())
    assert placed == n and loop.exit_step == n + 1   # one inactive step
    assert (picks[loop.exit_step:] == -1).all()
    assert not victims[loop.exit_step:].any()
    assert (scores[loop.exit_step:] == NEG).all()
    assert flagged.any() and loop.exit_step < k


def test_the_victims_of_a_node_are_a_prefix_of_its_eligible_columns():
    """The claimed-prefix pointer holds on the wide fixture, where one
    node gives up many of its 512 columns over several steps."""
    loop, (picks, victims, _, _) = model(edge_problem("wide"))
    assert (picks == 5).all() and int(loop.ptr[5]) == int(
        torch.nonzero(victims.any(dim=0)).max()) + 1


# ---------------------------------------------------------------------------
# the wrapper on stub cards
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch, stub_libs, cards):  # noqa: F811
    """CPU tensors taken for a card's (their device "cuda"), "cuda"
    allocations made on the CPU, every library a stub: the wrapper takes
    its kernel route and launches a stub."""
    cuda = torch.device("cuda")
    real = torch.empty

    def empty(*shape, device=None, **kw):
        return real(*shape, **kw)

    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: cuda))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch, "empty", empty)
    _ext.scratch_words.cache_clear()
    yield stub_libs
    _ext.scratch_words.cache_clear()


def test_preempt_solve_is_one_launch_with_its_library_sized_scratch(
        fake_card):
    """One nt_preempt_solve: the inputs' pointers, a scratch of the
    library's size (no taken bits), then the four outputs, the sizes and
    the scratch's word count."""
    args = [torch.from_numpy(np.asarray(a)) for a in edge_problem("wide")]
    args[6] = None                       # v_prio is never read
    query = _ext.entry("nt_preempt_solve_scratch_words")
    query.code = 77
    before = _ext.COUNTS.snapshot()["launches"]["preempt_solve"]
    picks, victims, flagged, scores = kernels.preempt_solve(*args)
    (call,) = fake_card["preempt"].fns["nt_preempt_solve"].calls
    inputs = [a for i, a in enumerate(args) if i != 6]
    assert call[:9] == tuple(a.data_ptr() for a in inputs)
    assert call[10:14] == (picks.data_ptr(), victims.data_ptr(),
                           flagged.data_ptr(), scores.data_ptr())
    assert call[14:] == (8, 512, 4, 3, 77, 1000)   # then the stream
    assert query.calls == [(8, 3)]
    assert _ext.COUNTS.snapshot()["launches"]["preempt_solve"] == before + 1
    assert victims.shape == (4, 512) and victims.dtype == torch.bool
