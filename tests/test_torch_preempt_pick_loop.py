"""B12's step loop (nomad_tpu_torch/csrc/preempt.cu ``nt_preempt_pick``)
on the CPU: its schedule in plain torch, and its host call on stub cards.

The kernel cannot run here (no ``nvcc``, no card), so this module keeps a
plain-torch model of what one launch does: B7's loop
(tests/test_torch_preempt_loop.py) without victims. The set-up pass copies
the carry (used, evictable), scores every node once and caches its order
key, ``desc_key(score) << 32 | index``, in the same two-level tree (one
minimum a 32-node segment, then the minimum over the segments). Each step
(warp 0 alone on the card) reads the top; stops at the first step whose
best score is NEG, writing -1 for it and every later step; writes -1 for
an inactive step; else commits the chosen node's row (used = min(used +
ask, avail), evictable = max(evictable - deficit, 0)), rescores it once
and refreshes its segment and the top.

The model's picks must equal ``preempt_pick_ref`` and the JAX package's
``preempt_pick`` exactly on tests/test_torch_preempt.py's fixtures, the
reference's pick parity fixture, N 1, N 33 and N 1,000 (ragged segments),
a fixture of inactive slots and one whose every node goes NEG mid-run. At
every step the cached keys equal a full rescore's and the tree's top is
the full argmax."""

import numpy as np
import pytest
import torch

from nomad_tpu.tensor import kernels as ref_kernels
from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import kernels
from nomad_tpu_torch.tensor.kernels import (NEG, _preempt_scores,
                                            preempt_pick_ref,
                                            preempt_score_ref)
from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)
from test_torch_preempt import (EDGES, SEEDS, _pick_args, edge_problem,
                                random_victim_problem)
from test_torch_preempt_loop import fake_card  # noqa: F401  (a fixture)
from test_torch_preempt_loop import (LANES, MASK32, WIDE, all_neg_problem,
                                     key_score, order_keys, ragged_problem,
                                     tree)


class PickLoop:
    """One nt_preempt_pick launch in plain torch. With ``checked`` the
    cache is held, after the set-up pass and after every placed step,
    against a full rescore: the keys, the segment minima and the top."""

    def __init__(self, available, used0, evictable0, ask, feasible,
                 net_prio, active, checked=False):
        self.a, self.ask, self.feasible = available, ask, feasible
        self.active = active
        self.pscore = preempt_score_ref(net_prio)
        self.n = available.shape[0]
        self.used = used0.clone()
        self.ev = evictable0.clone()
        score, _, _ = _preempt_scores(available, self.used, ask, feasible,
                                      self.ev, self.pscore)
        self.keys = order_keys(score, torch.arange(self.n))
        self.seg = tree(self.keys)
        self.checked = checked
        self.checks = 0

    def rescore(self, b: int) -> int:
        r = slice(b, b + 1)
        score, _, _ = _preempt_scores(self.a[r], self.used[r], self.ask,
                                      self.feasible[r], self.ev[r],
                                      self.pscore[r])
        return int(order_keys(score, torch.tensor([b]))[0])

    def verify(self) -> None:
        score, _, _ = _preempt_scores(self.a, self.used, self.ask,
                                      self.feasible, self.ev, self.pscore)
        assert torch.equal(self.keys,
                           order_keys(score, torch.arange(self.n)))
        assert torch.equal(self.seg, tree(self.keys))
        top = int(self.seg.min())
        assert top & MASK32 == int(torch.argmax(score))
        assert key_score(top) == float(score.max())
        self.checks += 1

    def run(self) -> torch.Tensor:
        k = self.active.shape[0]
        picks = torch.full((k,), -1, dtype=torch.int32)
        if self.checked:
            self.verify()
        self.exit_step = k
        for step in range(k):
            top = int(self.seg.min())
            if not key_score(top) > NEG:
                self.exit_step = step   # this step and the rest: -1
                break
            if not bool(self.active[step]):
                continue
            b = top & MASK32
            want = self.used[b] + self.ask
            deficit = torch.clamp_min(want - self.a[b], 0.0)
            self.used[b] = torch.minimum(want, self.a[b])
            self.ev[b] = torch.clamp_min(self.ev[b] - deficit, 0.0)
            picks[step] = b
            self.keys[b] = self.rescore(b)
            s = b // LANES
            self.seg[s] = self.keys[s * LANES:(s + 1) * LANES].min()
            if self.checked:
                self.verify()
        return picks


def model(args, checked=True):
    """The model's loop and picks on numpy ``args`` (preempt_pick's
    order)."""
    loop = PickLoop(*(torch.from_numpy(np.asarray(a)) for a in args),
                    checked=checked)
    return loop, loop.run()


def parity_problem():
    """The reference's pick parity fixture (tests/test_preemption.py:
    135-156) in float32: non-integral usage and evictable capacity."""
    rng = np.random.default_rng(5)
    n, d, k = 32, 4, 16
    avail = (rng.integers(2, 9, size=(n, d)) * 500).astype(np.float64)
    used = avail * rng.uniform(0.6, 1.0, size=(n, d))
    evictable = used * rng.uniform(0.0, 0.9, size=(n, d))
    ask = np.array([400, 300, 0, 0], dtype=np.float64)
    feasible = rng.random(n) > 0.2
    net_prio = rng.uniform(0, 100, size=n)
    active = np.ones(k, dtype=bool)
    f32 = np.float32
    return (avail.astype(f32), used.astype(f32), evictable.astype(f32),
            ask.astype(f32), feasible, net_prio.astype(f32), active)


def inactive_problem():
    """Seed 3's problem with every third slot inactive and a run of
    inactive slots at the end."""
    args = list(_pick_args(random_victim_problem(3, k=24)))
    active = np.ones(24, bool)
    active[::3] = False
    active[-4:] = False
    args[6] = active
    return tuple(args)


FIXTURES = ([(f"seed{s}", lambda s=s: _pick_args(random_victim_problem(s)))
             for s in SEEDS]
            + [(e, lambda e=e: _pick_args(edge_problem(e))) for e in EDGES]
            + [(f"n{n}", lambda n=n: _pick_args(ragged_problem(n)))
               for n in (1, 33, 1000)]
            + [("parity", parity_problem), ("inactive", inactive_problem),
               ("allneg", lambda: _pick_args(all_neg_problem()))]
            + [(name, lambda kw=kw: _pick_args(random_victim_problem(7,
                                                                     **kw)))
               for name, kw in WIDE.items()])


@pytest.mark.parametrize("name,make", FIXTURES, ids=[f for f, _ in FIXTURES])
def test_loop_equals_plain_and_jax(name, make):
    args = make()
    loop, got = model(args, checked=args[0].shape[0] <= 64)
    want = preempt_pick_ref(*(torch.from_numpy(np.asarray(a)) for a in args))
    assert torch.equal(got, want), name
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_kernels.preempt_pick(*args)),
        err_msg=name)
    if loop.checked:
        assert loop.checks == 1 + int((got >= 0).sum())


def test_loop_invariants_at_1000_nodes():
    """The ragged 1,000-node fixture with the invariants held at every
    step (the full rescore a step is the plain version's cost)."""
    loop, got = model(_pick_args(ragged_problem(1000, k=12)))
    assert loop.checks == 1 + int((got >= 0).sum()) > 1
    assert loop.seg.shape == (32,)


def test_every_node_goes_neg_mid_run():
    """Every node can evict exactly one request's worth: each takes one,
    then goes NEG; the loop exits at the first NEG step, and that step
    and every later one is -1."""
    args = _pick_args(all_neg_problem())
    loop, picks = model(args)
    n, k = args[0].shape[0], args[6].shape[0]
    assert int((picks >= 0).sum()) == n
    assert loop.exit_step == n + 1 < k          # one inactive step on the way
    assert (picks[loop.exit_step:] == -1).all()
    assert sorted(picks[picks >= 0].tolist()) == list(range(n))


def test_inactive_slots_change_nothing():
    """An inactive slot writes -1 and leaves the carry: the active slots'
    picks are those of the same problem with the inactive slots left
    out."""
    args = inactive_problem()
    _, picks = model(args)
    active = args[6]
    assert (picks.numpy()[~active] == -1).all()
    compact = list(args)
    compact[6] = np.ones(int(active.sum()), bool)
    _, dense = model(tuple(compact), checked=False)
    assert torch.equal(picks[torch.from_numpy(active)], dense)


# ---------------------------------------------------------------------------
# the wrapper on stub cards
# ---------------------------------------------------------------------------

def test_preempt_pick_is_one_launch_with_its_library_sized_scratch(
        fake_card):
    """One nt_preempt_pick: the inputs' pointers, a scratch of the
    library's size, the picks, then the sizes and the scratch's word
    count."""
    args = [torch.from_numpy(np.asarray(a))
            for a in _pick_args(random_victim_problem(0))]
    query = _ext.entry("nt_preempt_pick_scratch_words")
    query.code = 99
    before = _ext.COUNTS.snapshot()["launches"]["preempt_pick"]
    picks = kernels.preempt_pick(*args)
    (call,) = fake_card["preempt"].fns["nt_preempt_pick"].calls
    assert call[:7] == tuple(a.data_ptr() for a in args)
    assert call[8] == picks.data_ptr()
    assert call[9:13] == (24, 12, 3, 99)        # then the stream
    assert query.calls == [(24, 3)]
    assert picks.shape == (12,) and picks.dtype == torch.int32
    assert _ext.COUNTS.snapshot()["launches"]["preempt_pick"] == before + 1


def test_preempt_pick_launches_at_a_ninth_resource_column(fake_card):
    """d 9: one nt_preempt_pick (the library takes the wide instance),
    with the sizes and a scratch of the library's size."""
    args = [torch.from_numpy(np.asarray(a))
            for a in _pick_args(random_victim_problem(0, d=9))]
    query = _ext.entry("nt_preempt_pick_scratch_words")
    query.code = 97
    before = _ext.COUNTS.snapshot()["launches"]["preempt_pick"]
    picks = kernels.preempt_pick(*args)
    (call,) = fake_card["preempt"].fns["nt_preempt_pick"].calls
    assert call[:7] == tuple(a.data_ptr() for a in args)
    assert call[8] == picks.data_ptr()
    assert call[9:13] == (24, 12, 9, 97)        # then the stream
    assert query.calls == [(24, 9)]
    assert _ext.COUNTS.snapshot()["launches"]["preempt_pick"] == before + 1


def test_preempt_pick_refuses_only_past_shared_memory(fake_card):
    """The segment minima (8 bytes a 32 nodes) of 929,793 nodes exceed a
    CTA's shared memory: ValueError naming the bytes; a single column
    (the fit score reads two) raises too; neither launches. 929,792
    nodes pass the check."""
    k = 2
    for n, d in ((929_793, 2), (8, 1)):
        args = [torch.ones((n, d)), torch.zeros((n, d)), torch.zeros((n, d)),
                torch.ones(d), torch.ones(n, dtype=torch.bool),
                torch.zeros(n), torch.ones(k, dtype=torch.bool)]
        with pytest.raises(ValueError, match=("bytes of shared memory"
                                              if d > 1 else "columns")):
            kernels.preempt_pick(*args)
    assert not fake_card["preempt"].fns.get("nt_preempt_pick")
    assert kernels.preempt_smem_bytes(929_792, 40, False) == (
        kernels.SMEM_BYTES)
