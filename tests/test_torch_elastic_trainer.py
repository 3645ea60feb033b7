"""The port's elastic bounded-staleness local SGD (``ElasticCoordinator``,
``ElasticTrainer``) against the JAX package's, on the scenarios of
``tests/test_elastic.py``: hosts on threads over an
``InMemoryCoordinationStore``, no process group.

Every host starts from the same weights — the reference's checkpoint of
the harness MLP (``tests/_kill_harness.py``) loaded into the port — and
trains on the harness's per-host data schedule, a pure function of
(round, step).

- The committed average follows the JAX package's rule bit for bit: the
  round chain recomputed in numpy from the port's own steps (float64
  means, the canonical p0 + ΣR finalization) gives the fleet's digest.
- Against the JAX package's fleet on the same schedule the final
  parameters agree within ``STEP_TOL`` 1e-4 (relative; adam steps of two
  packages).
- Eviction of a dead host, rejoin as a new member and a kill/restore
  backfill behave as the reference's tests pin them.
"""

import threading
import traceback

import numpy as np
import pytest

import _kill_harness as harness

ROUNDS = 3
K = 2
SEED = 7
STEP_TOL = 1e-4


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from deeplearning4j_tpu.util.serialization import save_model
    path = str(tmp_path_factory.mktemp("elastic") / "harness.zip")
    save_model(harness.build_net(SEED), path)
    return path


def _net(ckpt):
    from deeplearning4j_tpu_torch.util.serialization import load_model
    return load_model(ckpt, device="cpu")


def _cfg(host, fleet=("h0", "h1"), **kw):
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticConfig
    kw.setdefault("steps_per_round", K)
    kw.setdefault("max_staleness", 1)
    kw.setdefault("lease_s", 5.0)
    kw.setdefault("poll_s", 0.01)
    return ElasticConfig(fleet=fleet, host=host, **kw)


def _trainer(ckpt, store, host, **kw):
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer
    from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
    ckdir = kw.pop("checkpoint_dir", None)
    return ElasticTrainer(_net(ckpt), store, _cfg(host, **kw),
                          checkpoint_dir=ckdir, registry=MetricsRegistry())


class _Die(Exception):
    pass


def _batch_fn(host_index, die_round=None):
    fn = harness.elastic_batch_fn(SEED, host_index)

    def gated(r, step):
        if die_round is not None and r >= die_round:
            raise _Die()
        return fn(r, step)
    return gated


class _Fleet:
    """N trainers on threads; every join is deadline-bounded."""

    def __init__(self):
        self.results, self.errors, self.trainers, self.threads = \
            {}, {}, {}, {}

    def start(self, trainer, batch_fn, rounds=ROUNDS):
        host = trainer.cfg.host
        self.trainers[host] = trainer

        def run():
            try:
                trainer.fit(batch_fn, rounds=rounds)
                self.results[host] = trainer.final_digest
            except Exception:
                self.errors[host] = traceback.format_exc()
        t = threading.Thread(target=run, daemon=True)
        self.threads[host] = t
        t.start()
        return trainer

    def join(self, timeout=90.0):
        for h, t in self.threads.items():
            t.join(timeout=timeout)
            assert not t.is_alive(), f"host {h} did not finish ({self.errors})"
        assert not self.errors, self.errors
        return self.results


def _leaves(net):
    from deeplearning4j_tpu_torch.parallel.elastic import _net_param_leaves
    return _net_param_leaves(net)


def _jleaves(jnet):
    import jax
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(jnet.params)]


def _rel_err(got, want):
    return max(float(np.abs(np.asarray(g, np.float64) - w).max())
               / max(float(np.abs(w).max()), 1e-30)
               for g, w in zip(got, want))


def test_coordinator_round_ledger_matches_the_reference():
    """The membership log, the contribution framing and the reduction of
    the port's coordinator equal the JAX package's on the same inputs."""
    from deeplearning4j_tpu.parallel import elastic as J
    from deeplearning4j_tpu.util.metrics import MetricsRegistry as JReg
    from deeplearning4j_tpu_torch.parallel import elastic as P
    from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
    rng = np.random.default_rng(0)
    fleet = ("h0", "h1", "h2")
    stores = (P.InMemoryCoordinationStore(), J.InMemoryCoordinationStore())
    coords = [P.ElasticCoordinator(stores[0], _cfg("h0", fleet=fleet),
                                   registry=MetricsRegistry()),
              J.ElasticCoordinator(stores[1], J.ElasticConfig(
                  fleet=fleet, host="h0", steps_per_round=K),
                  registry=JReg())]
    deltas = {h: [rng.normal(size=(3, 2)).astype(np.float32),
                  rng.normal(size=(4,)).astype(np.float32)] for h in fleet}
    for c, store in zip(coords, stores):
        c._append_log("evict", "h1", 2)
        c.rejoin("h1", 4, incarnation=2)
        for h in fleet:
            store.put(f"rounds/r{0:06d}/{h}.bin", P.pack_leaves(deltas[h]))
    assert [coords[0].members_for_round(r) for r in range(6)] == \
        [coords[1].members_for_round(r) for r in range(6)]
    assert P.pack_leaves(deltas["h0"]) == J.pack_leaves(deltas["h0"])
    red_p, red_j = coords[0].try_reduce(0), coords[1].try_reduce(0)
    for a, b in zip(red_p, red_j):
        np.testing.assert_array_equal(a, b)
    assert coords[0].reduce_record(0)["digest"] == \
        coords[1].reduce_record(0)["digest"]
    with pytest.raises(P.ElasticProtocolError, match="nondeterministic"):
        coords[0].publish_contribution(0, [deltas["h1"][0] + 1])


def test_fleet_converges_and_digests_agree(ckpt):
    from deeplearning4j_tpu_torch.parallel.elastic import \
        InMemoryCoordinationStore
    store = InMemoryCoordinationStore()
    fleet = _Fleet()
    for i, h in enumerate(("h0", "h1")):
        fleet.start(_trainer(ckpt, store, h), _batch_fn(i))
    results = fleet.join()
    assert len(set(results.values())) == 1
    assert all(tr.agreed is True for tr in fleet.trainers.values())


def _sequential_chain(nets, step, leaves_of, set_leaves):
    """The s=0 recurrence of the JAX package's protocol, simulated: per
    round each replica's delta, their float64 mean, each replica
    corrected to it; the canonical p0 + ΣR at the end."""
    fns = [_batch_fn(0), _batch_fn(1)]
    p0 = leaves_of(nets[0])
    acc = [l.astype(np.float64) for l in p0]
    for r in range(ROUNDS):
        deltas = []
        for n, fn in zip(nets, fns):
            before = leaves_of(n)
            for s in range(K):
                step(n, *fn(r, s))
            deltas.append([a - b for a, b in zip(leaves_of(n), before)])
        red = [(deltas[0][i].astype(np.float64)
                + deltas[1][i].astype(np.float64)) / 2.0
               for i in range(len(p0))]
        acc = [a + r_ for a, r_ in zip(acc, red)]
        for n, own in zip(nets, deltas):
            set_leaves(n, [(p.astype(np.float64)
                            + (red[i] - own[i].astype(np.float64))
                            ).astype(p.dtype)
                           for i, p in enumerate(leaves_of(n))])
    return [a.astype(l.dtype) for a, l in zip(acc, p0)]


def test_staleness_zero_follows_the_reference_averaging_rule(ckpt):
    from deeplearning4j_tpu.util.serialization import load_model as j_load
    from deeplearning4j_tpu_torch.parallel.elastic import (
        InMemoryCoordinationStore, _set_net_params_from_leaves)
    from deeplearning4j_tpu_torch.util.durable import params_digest
    store = InMemoryCoordinationStore()
    fleet = _Fleet()
    for i, h in enumerate(("h0", "h1")):
        fleet.start(_trainer(ckpt, store, h, max_staleness=0), _batch_fn(i))
    results = fleet.join()
    final_port = _leaves(fleet.trainers["h0"].net)
    # the rule, replayed on the port's own steps: the same digest bits
    nets = [_net(ckpt) for _ in range(2)]
    final = _sequential_chain(nets, lambda n, x, y: n.fit_batch(x, y),
                              _leaves, _set_net_params_from_leaves)
    _set_net_params_from_leaves(nets[0], final)
    assert set(results.values()) == {params_digest(nets[0].params, None, 0)}

    # the rule, replayed on the JAX package's steps: within STEP_TOL
    import jax

    def jset(n, leaves):
        flat, treedef = jax.tree_util.tree_flatten(n.params)
        n.params = jax.tree_util.tree_unflatten(treedef, list(leaves))
    jnets = [j_load(ckpt) for _ in range(2)]
    jfinal = _sequential_chain(jnets, lambda n, x, y: n.fit_batch(x, y),
                               _jleaves, jset)
    assert _rel_err(final_port, jfinal) <= STEP_TOL


def test_fleet_matches_the_reference_fleet(ckpt):
    """s=1, two hosts: the port's fleet and the JAX package's fleet on the
    same schedule end within STEP_TOL."""
    from deeplearning4j_tpu.parallel.elastic import (
        ElasticConfig as JCfg, ElasticTrainer as JTrainer,
        InMemoryCoordinationStore as JStore)
    from deeplearning4j_tpu.util.metrics import MetricsRegistry as JReg
    from deeplearning4j_tpu.util.serialization import load_model as j_load
    from deeplearning4j_tpu_torch.parallel.elastic import \
        InMemoryCoordinationStore
    store = InMemoryCoordinationStore()
    fleet = _Fleet()
    for i, h in enumerate(("h0", "h1")):
        fleet.start(_trainer(ckpt, store, h), _batch_fn(i))
    fleet.join()
    jstore = JStore()
    jfleet = _Fleet()
    for i, h in enumerate(("h0", "h1")):
        jfleet.start(JTrainer(j_load(ckpt), jstore, JCfg(
            fleet=("h0", "h1"), host=h, steps_per_round=K, max_staleness=1,
            lease_s=5.0, poll_s=0.01), registry=JReg()), _batch_fn(i))
    jfleet.join()
    assert _rel_err(_leaves(fleet.trainers["h0"].net),
                    _jleaves(jfleet.trainers["h0"].net)) <= STEP_TOL


def test_dead_host_hard_evicted_and_survivor_completes(ckpt):
    from deeplearning4j_tpu_torch.parallel.elastic import \
        InMemoryCoordinationStore
    from deeplearning4j_tpu_torch.util import flightrecorder as flight
    store = InMemoryCoordinationStore()
    h1 = _trainer(ckpt, store, "h1", lease_s=0.2, evict_after_s=0.2)
    with pytest.raises(_Die):
        h1.fit(_batch_fn(1, die_round=1), rounds=ROUNDS)
    n_evict = len(flight.events("elastic_evict"))
    h0 = _trainer(ckpt, store, "h0", lease_s=0.2, evict_after_s=0.2)
    h0.fit(_batch_fn(0), rounds=ROUNDS)
    assert h0.agreed is True and h0.final_digest is not None
    ctr = h0.registry.get("membership_transitions_total")
    assert ctr.value(event="hard_evict", host="h1") >= 1
    evs = [e for e in flight.events("elastic_evict")[n_evict:]
           if e.get("host") == "h1"]
    assert evs and evs[-1]["effective_round"] == 1
    assert sorted(h0.coord.reduce_record(0)["members"]) == ["h0", "h1"]
    assert h0.coord.reduce_record(ROUNDS - 1)["members"] == ["h0"]


def test_rejoin_after_hard_evict_syncs_to_fleet_digest(ckpt):
    from deeplearning4j_tpu_torch.parallel.elastic import \
        InMemoryCoordinationStore
    store = InMemoryCoordinationStore()
    h1 = _trainer(ckpt, store, "h1", lease_s=0.2, evict_after_s=0.2)
    with pytest.raises(_Die):
        h1.fit(_batch_fn(1, die_round=1), rounds=ROUNDS)
    h0 = _trainer(ckpt, store, "h0", lease_s=0.2, evict_after_s=0.2)
    h0.fit(_batch_fn(0), rounds=ROUNDS)
    h1b = _trainer(ckpt, store, "h1", lease_s=0.2, evict_after_s=0.2)
    h1b.fit(_batch_fn(1), rounds=ROUNDS)
    assert h1b.agreed is True
    assert h1b.final_digest == h0.final_digest
    assert h1b._member_from >= ROUNDS


def test_kill_restore_backfill_is_bit_identical(ckpt, tmp_path):
    from deeplearning4j_tpu_torch.parallel.elastic import \
        InMemoryCoordinationStore

    def run_pair(ckdirs, kill_round=None):
        store = InMemoryCoordinationStore()
        fleet = _Fleet()
        fleet.start(_trainer(ckpt, store, "h0", lease_s=60.0,
                             checkpoint_dir=str(ckdirs["h0"])), _batch_fn(0))
        if kill_round is not None:
            h1 = _trainer(ckpt, store, "h1", lease_s=60.0,
                          checkpoint_dir=str(ckdirs["h1"]))
            with pytest.raises(_Die):
                h1.fit(_batch_fn(1, die_round=kill_round), rounds=ROUNDS)
        h1b = fleet.start(_trainer(ckpt, store, "h1", lease_s=60.0,
                                   checkpoint_dir=str(ckdirs["h1"])),
                          _batch_fn(1))
        return fleet.join(), h1b

    clean, _ = run_pair({h: tmp_path / "a" / h for h in ("h0", "h1")})
    assert len(set(clean.values())) == 1
    killed, h1b = run_pair({h: tmp_path / "b" / h for h in ("h0", "h1")},
                           kill_round=1)
    assert h1b.resumed is True
    assert set(killed.values()) == set(clean.values())


def test_training_master_builds_the_elastic_trainer(ckpt, tmp_path):
    from deeplearning4j_tpu_torch.parallel import (ElasticTrainer,
                                                   ElasticTrainingMaster)
    master = ElasticTrainingMaster(str(tmp_path / "coord"), ("h0",), "h0",
                                   steps_per_round=1, max_staleness=0,
                                   lease_s=5.0)
    tr = master.build(_net(ckpt))
    assert isinstance(tr, ElasticTrainer)
    tr.fit(_batch_fn(0), rounds=2)
    assert tr.agreed is True
