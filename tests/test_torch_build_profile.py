"""GraphIndexBuilder's counters and build profile: the port's
`GraphIndexBuilder.counters` (`BuildCounters`) against the JAX package's.

Both builders take the same seeded numpy rows. `rounds` and
`nodes_inserted` must be equal after `build` and after `add_nodes`, and
`nodes_deleted` stays 0 in both (nothing increments it). With
`BUILD_PROFILE` set in both modules, `phase_s` holds the same phase names
in both; with it off, it is empty in both. On the port, a profiled build
returns the adjacency of an unprofiled one, and with the profile off no
phase waits on the device (`_sync` is never called).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.models import builder as jbuilder
from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu_torch.models import builder as tbuilder
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

torch.set_num_threads(2)

D, N_ADD = 16, 300
# (rows built, batch_size, max_degree): a bootstrap block of batch_size,
# then the ramp; the delta insert takes one or two chunks
CASES = [(1200, 256, 12), (1500, 512, 16), (2000, 1024, 8)]
PHASES = {"search", "prune+fwd", "sel_fetch", "backedges_host", "apply",
          "overflow", "cleanup_fetch", "cleanup_splice", "cleanup_overflow",
          "cleanup_orphans"}


def _rows(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


def _capacity(n):
    return 1 << (n - 1).bit_length()


def _jax_builder(batch, deg):
    return jbuilder.GraphIndexBuilder(dim=D, max_degree=deg, beam_width=32,
                                      batch_size=batch)


def _port_builder(batch, deg):
    return tbuilder.GraphIndexBuilder(dim=D, max_degree=deg, beam_width=32,
                                      batch_size=batch)


def _counts(c):
    return c.rounds, c.nodes_inserted, c.nodes_deleted


@pytest.mark.parametrize("case", CASES, ids=str)
def test_counters_match_the_reference(case):
    n, batch, deg = case
    rows = _rows(n + N_ADD)
    cap = _capacity(n + N_ADD)
    dead = np.arange(0, n, 7)
    new_ids = np.arange(n, n + N_ADD)

    jb = _jax_builder(batch, deg)
    jg = jb.build(jnp.asarray(rows[:n]), JSim.EUCLIDEAN, capacity=cap)
    j_built = _counts(jb.counters)
    jg = jb.add_nodes(jg, jnp.asarray(rows), new_ids, JSim.EUCLIDEAN)
    j_added = _counts(jb.counters)
    jb.cleanup(jb.mark_deleted(jg, dead), jnp.asarray(rows), JSim.EUCLIDEAN)

    tb = _port_builder(batch, deg)
    tg = tb.build(torch.from_numpy(rows[:n]), SimilarityFunction.EUCLIDEAN,
                  capacity=cap)
    t_built = _counts(tb.counters)
    tg = tb.add_nodes(tg, torch.from_numpy(rows), new_ids,
                      SimilarityFunction.EUCLIDEAN)
    t_added = _counts(tb.counters)
    tb.cleanup(tb.mark_deleted(tg, dead), torch.from_numpy(rows),
               SimilarityFunction.EUCLIDEAN)

    assert t_built == j_built and t_built[1:] == (n, 0)
    assert t_added == j_added and t_added[1:] == (n + N_ADD, 0)
    assert _counts(tb.counters) == _counts(jb.counters)
    assert tb.counters.nodes_deleted == 0


@pytest.mark.parametrize("profile", [True, False], ids=["on", "off"])
def test_phase_names_match_the_reference(profile, monkeypatch):
    n, batch, deg = CASES[0]
    rows = _rows(n + N_ADD)
    monkeypatch.setattr(jbuilder, "BUILD_PROFILE", profile)
    monkeypatch.setattr(tbuilder, "BUILD_PROFILE", profile)
    cap = _capacity(n + N_ADD)
    new_ids = np.arange(n, n + N_ADD)

    jb = _jax_builder(batch, deg)
    jg = jb.build(jnp.asarray(rows[:n]), JSim.EUCLIDEAN, capacity=cap)
    jb.add_nodes(jg, jnp.asarray(rows), new_ids, JSim.EUCLIDEAN)
    tb = _port_builder(batch, deg)
    tg = tb.build(torch.from_numpy(rows[:n]), SimilarityFunction.EUCLIDEAN,
                  capacity=cap)
    tb.add_nodes(tg, torch.from_numpy(rows), new_ids,
                 SimilarityFunction.EUCLIDEAN)

    if profile:
        assert set(tb.counters.phase_s) == set(jb.counters.phase_s) == PHASES
        assert all(v >= 0.0 for v in tb.counters.phase_s.values())
    else:
        assert tb.counters.phase_s == {} and jb.counters.phase_s == {}


def test_profile_changes_no_edge_and_waits_only_when_on(monkeypatch):
    n, batch, deg = CASES[1]
    rows = torch.from_numpy(_rows(n + N_ADD))
    simf = SimilarityFunction.EUCLIDEAN
    syncs = []
    monkeypatch.setattr(tbuilder, "_sync", syncs.append)
    graphs = {}
    for profile in (False, True):
        monkeypatch.setattr(tbuilder, "BUILD_PROFILE", profile)
        syncs.clear()
        b = _port_builder(batch, deg)
        g = b.build(rows[:n], simf, capacity=_capacity(n + N_ADD))
        g = b.add_nodes(g, rows, np.arange(n, n + N_ADD), simf)
        g = b.cleanup(b.mark_deleted(g, np.arange(0, n, 5)), rows, simf)
        graphs[profile] = g
        if profile:
            assert len(syncs) > 0 and set(b.counters.phase_s) == PHASES
        else:
            assert syncs == [] and b.counters.phase_s == {}
    off, on = graphs[False], graphs[True]
    assert torch.equal(off.adjacency, on.adjacency)
    assert torch.equal(off.degrees, on.degrees)
    assert torch.equal(off.live, on.live) and off.entry == on.entry
