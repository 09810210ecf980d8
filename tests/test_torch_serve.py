"""The port's serving loop against the JAX package, on the CPU.

  * ``two_hop_neighbors`` on one slab image (the JAX session's, restored
    into the port's): ids, weights, member counts and truncations equal
    to the JAX program's, out-of-range query ids included; queries in
    groups (a device budget of one query) equal one call.
  * ``ServeSession``: the cases of ``tests/test_service.py:260-367``
    (coalesced absorb rounds with gid-stable tickets, a trailing query
    set for set equal to the host spanner path, the delta stream
    replaying the slabs, zero edge fetches; backpressure and truncation)
    and ``tests/test_cluster.py:327`` (clusterings served between rounds),
    each run by the JAX session and by the port's, restored from the JAX
    checkpoint: every ``stats`` counter equal, every answer equal.
  * ``serve_forever`` on a thread, stopped by ``shutdown``.
"""

import threading

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro's modules in a working order)
import jax.numpy as jnp
from repro.core import GraphBuilder as JBuilder
from repro.core import HashFamilyConfig as JHash
from repro.core import StarsConfig as JConfig
from repro.data import mnist_like_points
from repro.graph import accumulator as j_acc
from repro.service import ServeConfig as JServeConfig
from repro.service import ServeSession as JServeSession
from repro.service import two_hop_neighbors as j_two_hop
from repro_torch import GraphBuilder
from repro_torch.core.convert import (checkpoint_from_reference,
                                      config_from_reference)
from repro_torch.graph import accumulator as t_acc
from repro_torch.service import (ServeConfig, ServeSession, apply_delta,
                                 two_hop_neighbors)

pytestmark = pytest.mark.torch_port

CPU = "cpu"


def _cfg(**kw):
    base = dict(mode="sorting", scoring="stars",
                family=JHash("simhash", m=16), measure="cosine", r=6,
                window=32, leaders=8, degree_cap=20, seed=3)
    base.update(kw)
    return JConfig(**base)


def _pair(x, jc):
    """A JAX builder after its repetitions, and the port's restored from
    its checkpoint: one slab image, where both delta streams start."""
    jb = JBuilder(x, jc).add_reps(jc.r)
    ckpt = jb.checkpoint()
    tb = GraphBuilder.restore(x, config_from_reference(jc),
                              checkpoint_from_reference(ckpt), device=CPU)
    return jb, tb, ckpt


@pytest.fixture(scope="module")
def points():
    feats, _ = mnist_like_points(n=420, d=24, classes=6, spread=0.25, seed=0)
    return np.array(feats.dense)


@pytest.mark.parametrize("q_cap", [2, 40, 300])
def test_two_hop_neighbors_equal_jax(points, q_cap):
    jb, tb, _ = _pair(points[:300], _cfg(r=3, degree_cap=8))
    st = jb.slab_state()
    q = np.array([0, 5, 299, -1, 300, 17, 17, 123], np.int32)
    want = [np.asarray(a) for a in j_two_hop(st.nbr, st.w, jnp.asarray(q),
                                             q_cap=q_cap)]
    ts = tb.slab_state()
    one = [t.numpy() for t in two_hop_neighbors(ts.nbr, ts.w, q,
                                                q_cap=q_cap)]
    grouped = [t.numpy() for t in two_hop_neighbors(ts.nbr, ts.w, q,
                                                    q_cap=q_cap,
                                                    group_bytes=1)]
    for a, b, c in zip(want, one, grouped):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)
    assert one[0].dtype == np.int32 and one[2].dtype == np.int32
    assert (one[2][:3] > 0).all() and (one[2][3:5] == 0).all()


def _drain(session_cls, config_cls, builder, feats, base, deltas):
    sess = session_cls(
        builder, config_cls(batch_window=2, max_queue=64, reps_per_absorb=1,
                            query_capacity=512),
        on_delta=deltas.append)
    tickets = [sess.submit_extend(feats[base + 3 * i:base + 3 * (i + 1)])
               for i in range(4)]
    tq = sess.submit_query([0, 5, 100, 411])
    return sess, tickets, tq, sess.run_until_idle()


def test_serving_loop_coalesces_answers_and_meters(points):
    """tests/test_service.py:261 on both packages: 4 queued extends in 2
    absorb rounds, a trailing query, the delta stream, no edge fetch."""
    base = 408
    jb, tb, ckpt = _pair(points[:base], _cfg(r=4))
    j_deltas, t_deltas = [], []
    _, j_tickets, j_tq, j_stats = _drain(JServeSession, JServeConfig, jb,
                                         points, base, j_deltas)
    fetches = (t_acc.transfer_stats["edge_fetches"],
               t_acc.transfer_stats["bytes"])
    _, t_tickets, t_tq, t_stats = _drain(ServeSession, ServeConfig, tb,
                                         points, base, t_deltas)
    assert (t_acc.transfer_stats["edge_fetches"],
            t_acc.transfer_stats["bytes"]) == fetches
    assert t_stats == j_stats
    assert t_stats["absorb_rounds"] == 2 and t_stats["points_absorbed"] == 12
    assert t_stats["deltas_emitted"] == 2 and t_stats["queries_served"] == 4
    assert [t.result for t in t_tickets] == [t.result for t in j_tickets]
    assert t_tickets[3].result == {"first_gid": base + 9, "count": 3}
    # the extends scored new points in both packages, whose dot products
    # may differ by an ulp (repro_torch.testing): members and counts are
    # exact, weights within 1e-6
    for key in ("nodes", "counts"):
        np.testing.assert_array_equal(t_tq.result[key], j_tq.result[key])
    for t_ids, t_w, j_ids, j_w in zip(t_tq.result["ids"],
                                      t_tq.result["weights"],
                                      j_tq.result["ids"],
                                      j_tq.result["weights"]):
        t_order, j_order = np.argsort(t_ids), np.argsort(j_ids)
        np.testing.assert_array_equal(t_ids[t_order], j_ids[j_order])
        np.testing.assert_allclose(t_w[t_order], j_w[j_order], rtol=0,
                                   atol=1e-6)
    g = tb.finalize()
    for row, cnt, exp in zip(t_tq.result["ids"], t_tq.result["counts"],
                             g.two_hop_sets(np.array([0, 5, 100, 411]))):
        assert set(row[row >= 0].tolist()) == set(exp.tolist())
        assert int(cnt) == exp.size
    # the stream starts at the checkpoint the session was restored from
    nbr, w = ckpt.nbr, ckpt.w
    for d in t_deltas:
        nbr, w = apply_delta(nbr, w, d)
    ck = tb.checkpoint()
    np.testing.assert_array_equal(nbr, ck.nbr)
    np.testing.assert_array_equal(w, ck.w)


def test_serving_loop_backpressure_and_truncation(points):
    """tests/test_service.py:318 on both packages."""
    x = points[:300]
    jb, tb, _ = _pair(x, _cfg(r=3, seed=5))
    with pytest.raises(ValueError, match="unscored"):
        ServeSession(GraphBuilder(x, config_from_reference(_cfg()),
                                  device=CPU))
    runs = []
    for session_cls, config_cls, b in ((JServeSession, JServeConfig, jb),
                                       (ServeSession, ServeConfig, tb)):
        sess = session_cls(b, config_cls(max_queue=6, query_capacity=2,
                                         emit_deltas=False))
        tickets = [sess.submit_query([i]) for i in range(10)]
        runs.append((tickets, sess.run_until_idle()))
    (j_tickets, j_stats), (t_tickets, t_stats) = runs
    assert t_stats == j_stats
    assert t_stats["rejections"] == 4 and t_stats["queue_depth_hwm"] == 6
    assert t_stats["queries_served"] == 6 and t_stats["deltas_emitted"] == 0
    counts = [int(t.result["counts"][0]) for t in t_tickets if t is not None]
    assert t_stats["query_truncations"] == sum(c > 2 for c in counts) > 0
    for jt, tt in zip(j_tickets, t_tickets):
        assert (jt is None) == (tt is None)
        if tt is not None:
            np.testing.assert_array_equal(tt.result["ids"],
                                          jt.result["ids"])
            assert (tt.result["ids"][0] >= 0).sum() == min(
                2, int(tt.result["counts"][0]))


def test_serve_session_cluster_requests():
    """tests/test_cluster.py:328 on both packages: a clustering queued
    after an insert sees it, labels equal, no edge fetch."""
    feats, _ = mnist_like_points(n=160, d=16, classes=4, spread=0.15,
                                 seed=9)
    x = np.array(feats.dense)
    jc = _cfg(family=JHash("simhash", m=8), r=4, window=32, leaders=6,
              degree_cap=10, seed=4)
    jb, tb, _ = _pair(x[:140], jc)
    runs = []
    for session_cls, b, acc in ((JServeSession, jb, j_acc),
                                (ServeSession, tb, t_acc)):
        sess = session_cls(b)
        t_ext = sess.submit_extend(x[140:])
        t_cc = sess.submit_cluster("components")
        t_af = sess.submit_cluster("affinity", target_clusters=4)
        acc.reset_transfer_stats()
        stats = sess.run_until_idle()
        assert t_ext.done and t_cc.done and t_af.done
        assert acc.transfer_stats["edge_fetches"] == 0
        assert acc.transfer_stats["bytes"] == 0
        runs.append((t_cc.result, t_af.result, stats))
    (j_cc, j_af, j_stats), (t_cc, t_af, t_stats) = runs
    assert t_stats == j_stats
    assert t_stats["clusterings_served"] == 2
    assert t_stats["cluster_label_bytes"] == 2 * 160 * 4
    assert t_cc["labels"].shape == (160,) and t_cc["info"]["converged"]
    np.testing.assert_array_equal(t_cc["labels"], j_cc["labels"])
    np.testing.assert_array_equal(t_af["labels"], j_af["labels"])
    assert t_af["info"] == j_af["info"]
    np.testing.assert_array_equal(t_cc["labels"], tb.cluster("components"))


def test_serve_forever_on_a_thread(points):
    x = points[:300]
    b = GraphBuilder(x, config_from_reference(_cfg(r=2)),
                     device=CPU).add_reps()
    sess = ServeSession(b, ServeConfig(reps_per_absorb=1,
                                       emit_deltas=False))
    loop = threading.Thread(target=sess.serve_forever, daemon=True)
    loop.start()
    t_ext = sess.submit_extend(torch.from_numpy(points[300:310]))
    t_q = sess.submit_query([305])
    for _ in range(2000):
        if t_q.done:
            break
        threading.Event().wait(0.01)
    sess.shutdown()
    loop.join(timeout=30)
    assert not loop.is_alive()
    assert t_ext.done and t_ext.result == {"first_gid": 300, "count": 10}
    assert t_q.done and int(t_q.result["counts"][0]) > 0
    assert sess.stats["absorb_rounds"] == 1 and b.n == 310
