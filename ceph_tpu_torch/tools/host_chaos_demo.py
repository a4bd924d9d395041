"""host_chaos_demo — take a whole host fault domain out mid-scenario,
watch the multi-host plane survive it: the counterpart of the
reference's ``tools/host_chaos_demo.py``.

Two modes, both seeded and gate-checked:

**In-process (default).** One "production day" (the scenario harness,
FakeClock + sim service model, the DEVICE executor) runs on a
multi-host plane (``hosts`` fault domains carved out of the visible
members, parallel/plane.py) and loses host ``--host`` at a WARM seam: a
seeded HostLoss/HostFlap/HostPartition (chaos/hosts.py) fires at the
fused-repair seam's Nth poll.  The supervisor must classify it as
``host_loss``, quarantine the WHOLE domain in one host-granular
reshrink, replay the lost host's journaled in-flight intents onto the
survivor, finish the stream, and — once the adversary releases the
host — re-promote back to full host width after clean health probes.

Gates (all must hold for rc 0): the run replays byte-identically; the
client stream byte-verifies and recovery converges healed; the heal is
BYTE-IDENTICAL to the unfailed control run; the host fault fired; the
quarantine is visible (``host_quarantines`` >= 1 and a
``host_quarantined`` flight dump); the plane re-promotes to its
original host topology.

**Kill-one (--kill-one).** The real-process version: the demo spawns
two worker processes (each a simulated host with its own interpreter
and ``CEPH_TPU_TORCH_VIRTUAL_DEVICES`` members, ``CEPH_TPU_HOSTS=2``),
lets both stream repair batches, then SIGKILLs the peer MID-BATCH.  The
survivor detects the loss through its peer heartbeat probe
(utils/retry.py ``probe_call``: a file the peer rewrites, so a peer
killed while it holds a CUDA context cannot hang it), arms a persistent
HostLoss record for the dead domain and routes the in-flight batch
through the supervised seam: host quarantine, in-flight reclaim,
completion on the shrunken plane.  The peer never comes back, so the
plane stays shrunken.  The gates: survivor rc 0, victim died by
SIGKILL, loss detected via ProbeTimeout, ``host_quarantines`` >= 1,
in-flight batch re-dispatched, topology 2 -> 1 hosts and stayed,
every batch byte-identical to the numpy twin.  Every child process and
every wait carries a timeout.

    python -m ceph_tpu_torch.tools.host_chaos_demo
    python -m ceph_tpu_torch.tools.host_chaos_demo --fault host_flap
    python -m ceph_tpu_torch.tools.host_chaos_demo --erasures 4  # rc 2
    python -m ceph_tpu_torch.tools.host_chaos_demo --kill-one --json

Differences from the reference, by design: ``--device host|cuda|cpu``
(default ``cuda``; ``NoDeviceError`` without a card).  The in-process
day's plane is formed from the members ``CEPH_TPU_TORCH_VIRTUAL_DEVICES``
makes visible (with one card and no virtual members no plane forms and
the host-loss gates cannot hold).  The kill-one workers use
``CEPH_TPU_TORCH_VIRTUAL_DEVICES=4`` in place of the reference's
``XLA_FLAGS``; on the card each holds a CUDA context, and the
survivor's batch body is the port's GF(2^8) apply of an all-ones row
(the XOR of the survivors) over the card plane, with the numpy XOR as
its host twin; its report adds the kernels the survivor launched.

Exit codes: 0 = all gates held; 2 = unrecoverable objects reported
(structured report still printed); 3 = a gate failed (must never
happen); 1 = usage/config error.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

from ..scenario import default_scenario, run_scenario
from ..serve.loadgen import throughput_service_model
from ..utils.retry import FakeClock
from . import _demo
from ._demo import dump_triggers as _dump_triggers
from ._demo import stores_identical as _stores_identical


def _run(spec, device: str = "cuda"):
    return run_scenario(spec, clock=FakeClock(),
                        service_model=throughput_service_model(),
                        **_demo.run_kwargs(device))


# ----------------------------------------------------------------------
# in-process mode: the scenario harness on a simulated multi-host plane

def _scenario_mode(a) -> int:
    base = default_scenario(
        seed=a.seed, n_requests=a.requests, stripe_size=a.stripe,
        damaged_objects=a.objects, erasures=a.erasures,
        storm_events=a.churn)
    spec = replace(base, chaos=replace(
        base.chaos, host_loss=a.fault, host_loss_host=a.host,
        host_loss_hosts=a.hosts, host_loss_seam=a.seam,
        host_loss_at=a.at, host_loss_calls=a.calls or None))
    control = replace(base, chaos=replace(base.chaos, host_loss=None))

    # one untimed warm-up pass, same reasoning as device_chaos_demo:
    # run and replay must start from identical program state
    _run(spec, a.device)

    run = _run(spec, a.device)
    rep = run.report
    if rep.gates["unrecoverable"]:
        out = {"report": rep.to_dict(), "gates": {}}
        print(json.dumps(out, indent=1, sort_keys=True)
              if a.json_out else
              f"UNRECOVERABLE objects: {rep.gates['unrecoverable']}")
        return 2
    replay = _run(spec, a.device)
    ctrl = _run(control, a.device)

    hp = rep.host_plane or {}
    counters = hp.get("counters", {})
    gates = {
        "replay_identical": rep.to_json() == replay.report.to_json(),
        "converged": rep.gates["converged"],
        "healed": rep.gates["healed"],
        "verified_requests": rep.gates["verified_requests"],
        "control_converged_healed": (
            ctrl.report.gates["converged"]
            and ctrl.report.gates["healed"]),
        "heal_byte_identical_vs_control": _stores_identical(
            run.stores, ctrl.stores),
        "host_fault_fired": hp.get("plan", {}).get("fired", 0) >= 1,
        "host_quarantined": counters.get("host_quarantines", 0) >= 1,
        "host_quarantine_flight_dump":
            "host_quarantined" in _dump_triggers(),
        "repromoted_to_full_width": (
            counters.get("host_repromotions", 0) >= 1
            and hp.get("topology_at_end") == hp.get("topology_armed")
            and not hp.get("demoted_at_end")),
    }

    out = {"spec": spec.to_dict(), "report": rep.to_dict(),
           "gates": gates}
    rc = 0 if all(gates.values()) else 3
    if a.json_out:
        print(json.dumps(out, indent=1, sort_keys=True))
        return rc
    print(f"host-chaos '{rep.name}' seed={rep.seed} "
          f"fault={a.fault}@{a.seam}#{a.at} host={a.host}/"
          f"{a.hosts} calls={a.calls or 'persistent'}")
    print(f"  host plane: armed={hp.get('topology_armed')} "
          f"end={hp.get('topology_at_end')}")
    print(f"  counters: {dict(sorted(counters.items()))}")
    print(f"  plan: {hp.get('plan')}")
    print(f"  flight dumps: {_dump_triggers()}")
    bad = [k for k, v in gates.items() if not v]
    print("gates: " + ("ALL OK" if not bad else f"FAILED {bad}"))
    return rc


# ----------------------------------------------------------------------
# kill-one mode: two real processes, the demo SIGKILLs one mid-batch

_HB_TICK_S = 0.05       # victim heartbeat cadence
_BATCH_PACE_S = 0.25    # survivor inter-batch pacing (real clock: the
                        # staleness detection needs wall time to pass)
_WORKER_MEMBERS = "4"   # CEPH_TPU_TORCH_VIRTUAL_DEVICES per worker
_SURVIVOR_TIMEOUT_S = 300.0


def _hb_path(d: str, rank: int) -> str:
    return os.path.join(d, f"hb_{rank}")


def _write_file(path: str, value: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(value)
    os.replace(tmp, path)  # atomic: the reader never sees a torn write


def _read_int(path: str) -> int:
    try:
        with open(path) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return -1


def _local_repair(stack) -> np.ndarray:
    """XOR-parity repair of the erased shard from the k survivors, in
    numpy: the batch body's ground-truth twin."""
    stack = np.asarray(stack.cpu() if hasattr(stack, "cpu") else stack)
    out = stack[0].copy()
    for row in stack[1:]:
        out ^= row
    return out


def _device_repair(stack):
    """The same XOR on the worker's device: the GF(2^8) apply of an
    all-ones row (on the card, the kernel the routing picks for it),
    over the active plane's members."""
    from ..ops.gf_kernels import apply_matrix_best
    ones = (tuple([1] * stack.shape[0]),)
    return apply_matrix_best(stack[None], ones)[0, 0]


def _victim_worker(a) -> int:
    """Rank 1: heartbeat until killed (on the card, holding a CUDA
    context).  The bounded lifetime means a crash of the demo cannot orphan
    it."""
    if a.device == "cuda":
        import torch
        torch.zeros(1, device=_demo.torch_device(a.device))
        torch.cuda.synchronize()
    hb = _hb_path(a.dir, 1)
    end = time.monotonic() + 120.0
    tick = 0
    while time.monotonic() < end:
        tick += 1
        _write_file(hb, str(tick))
        time.sleep(_HB_TICK_S)
    return 0


def _survivor_worker(a) -> int:
    """Rank 0: stream repair batches on the 2-host plane, heartbeat-
    probe the peer before each, and when the probe times out route the
    in-flight batch through the supervised seam as a host loss."""
    import torch

    from ..chaos.hosts import HostFaultPlan, HostLoss, arm_host_plan
    from ..ops.launches import launch_counts
    from ..ops.supervisor import DispatchSupervisor
    from ..parallel import plane as planemod
    from ..utils.errors import ProbeTimeout, TransientBackendError
    from ..utils.retry import RetryPolicy, probe_call

    dev = _demo.torch_device(a.device)
    # CEPH_TPU_HOSTS=2 and the virtual members come from the demo
    plane = planemod.activate(None, kind=dev.type)
    topo0 = planemod.host_plane_topology(plane)
    sup = DispatchSupervisor(promote_after=2, probe_every=1)
    reclaimed: list = []
    sup.set_inflight_reclaim(lambda seam: reclaimed.append(seam) or 1)

    hb = _hb_path(a.dir, 1)
    prog = os.path.join(a.dir, "prog_0")
    killed_marker = os.path.join(a.dir, "killed")
    deadline = time.monotonic() + 60.0
    while not os.path.exists(hb):
        if time.monotonic() > deadline:
            print(json.dumps({"error": "peer never heartbeat"}))
            return 1
        time.sleep(_HB_TICK_S)

    last_seen = {"v": -1}

    def check_hb() -> int:
        v = _read_int(hb)
        if v == last_seen["v"]:
            # unchanged since the last read: transient — the retry
            # schedule re-reads; a live peer advances within one tick
            raise TransientBackendError(
                f"host 1 heartbeat stale at {v}")
        last_seen["v"] = v
        return v

    probe_policy = RetryPolicy(attempts=4, base_delay=0.2,
                               multiplier=1.0, max_delay=0.2)
    peer_dead = False
    detect = None

    def probe_peer() -> None:
        nonlocal peer_dead, detect
        try:
            probe_call(check_hb, target="host1", deadline=2.0,
                       policy=probe_policy)
        except ProbeTimeout as e:
            peer_dead = True
            detect = {"elapsed": round(e.elapsed, 3),
                      "target": e.target}
            # the dead domain becomes a PERSISTENT adversary record —
            # the same HostLoss the chaos plane arms — so the
            # supervisor's ladder fires host-granularly on the next
            # seam poll and its health probe refuses to re-admit the
            # domain while the record stands (pending_persistent)
            arm_host_plan(HostFaultPlan(
                [HostLoss(1, seam="demo.host_repair", at=1,
                          calls=None)], seed=a.seed))

    healed = True
    for i in range(a.batches):
        if not peer_dead:
            # synchronize with the demo's kill: once the marker is
            # down, keep probing until the stale heartbeat surfaces —
            # detection still comes from ProbeTimeout, the marker only
            # bounds the wait
            limit = time.monotonic() + 30.0
            while True:
                probe_peer()
                if peer_dead or not os.path.exists(killed_marker):
                    break
                if time.monotonic() > limit:
                    break
                time.sleep(_HB_TICK_S)
        rng = np.random.default_rng(a.seed + i)
        shards = rng.integers(0, 256, (4, a.stripe), dtype=np.uint8)
        parity = _local_repair(shards)
        stack = np.concatenate(
            [shards[1:], parity[None]])  # shard 0 erased
        if a.device == "host":
            fn, arg = _local_repair, stack
        else:
            fn, arg = _device_repair, torch.from_numpy(stack).to(dev)
        out = sup.dispatch("demo.host_repair", fn, (arg,),
                           host_fn=_local_repair, rebuild=lambda: fn)
        healed = healed and bytes(_local_repair(out[None])) == \
            bytes(shards[0])
        _write_file(prog, str(i + 1))
        time.sleep(_BATCH_PACE_S)

    st = sup.stats()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: v for k, v in launch_counts().items() if v}
    # the quarantine REPLACED the global plane — read the end topology
    # from the global before tearing it down
    topo_end = planemod.host_plane_topology()
    arm_host_plan(None)
    planemod.set_data_plane(None)
    print(json.dumps({
        "rank": 0, "batches": a.batches, "healed": healed,
        "peer_loss_detected": peer_dead, "detect": detect,
        "topology0": topo0,
        "topology_end": topo_end,
        "reclaim_calls": len(reclaimed),
        "counters": {k: st[k] for k in (
            "host_quarantines", "host_repromotions",
            "journal_redispatches", "quarantines", "demotions",
            "dispatch_errors", "completions") if k in st},
        "demoted_at_end": st["demoted"],
        "launches": launches,
    }, sort_keys=True))
    return 0


def _kill_one_mode(a) -> int:
    if a.device != "host":
        _demo.torch_device(a.device)    # NoDeviceError before any spawn
    d = tempfile.mkdtemp(prefix="host_chaos_")
    env = dict(os.environ)
    env["CEPH_TPU_TORCH_VIRTUAL_DEVICES"] = _WORKER_MEMBERS
    env["CEPH_TPU_HOSTS"] = "2"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])

    def spawn(rank: int) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.tools.host_chaos_demo",
             "--worker", str(rank), "--dir", d,
             "--batches", str(a.batches), "--stripe", str(a.stripe),
             "--seed", str(a.seed), "--device", a.device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    victim = spawn(1)
    survivor = spawn(0)
    rc = 3
    out = err = ""
    try:
        # wait for BOTH streams to be warm — the victim heartbeating,
        # the survivor past two healthy probed batches — then SIGKILL
        # the victim mid-batch (no shutdown handler runs: this is the
        # power-cord case, not a clean exit)
        prog = os.path.join(d, "prog_0")
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if (_read_int(_hb_path(d, 1)) >= 1
                    and _read_int(prog) >= 2):
                break
            if survivor.poll() is not None:
                break
            time.sleep(_HB_TICK_S)
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
        _write_file(os.path.join(d, "killed"), "1")

        out, err = survivor.communicate(timeout=_SURVIVOR_TIMEOUT_S)
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        report = json.loads(lines[-1]) if lines else {}
        counters = report.get("counters", {})
        topo0 = report.get("topology0") or {}
        topo_end = report.get("topology_end") or {}
        gates = {
            "survivor_clean_exit": survivor.returncode == 0,
            "victim_sigkilled": victim.returncode == -signal.SIGKILL,
            "two_host_plane_formed": topo0.get("hosts") == 2,
            "loss_detected_by_probe":
                bool(report.get("peer_loss_detected")),
            "host_quarantined":
                counters.get("host_quarantines", 0) >= 1,
            "inflight_redispatched": (
                counters.get("journal_redispatches", 0) >= 1
                and report.get("reclaim_calls", 0) >= 1),
            "reshrunk_and_stayed": (
                topo_end.get("hosts") == 1
                and counters.get("host_repromotions", 0) == 0),
            "healed_byte_identical": bool(report.get("healed")),
        }
        rc = 0 if all(gates.values()) else 3
        result = {"gates": gates, "survivor": report,
                  "victim_returncode": victim.returncode}
        if a.json_out:
            print(json.dumps(result, indent=1, sort_keys=True))
        else:
            print(f"kill-one: victim rc={victim.returncode} "
                  f"survivor rc={survivor.returncode}")
            print(f"  survivor: {json.dumps(report, sort_keys=True)}")
            bad = [k for k, v in gates.items() if not v]
            print("gates: " + ("ALL OK" if not bad
                               else f"FAILED {bad}"))
        if rc != 0 and err:
            print(err, file=sys.stderr)
    except subprocess.TimeoutExpired as e:
        print(f"host_chaos_demo: a worker outlived its timeout ({e})",
              file=sys.stderr)
        rc = 3
    finally:
        for p in (victim, survivor):
            if p.poll() is None:
                p.kill()
            try:
                p.communicate(timeout=30)
            except (subprocess.TimeoutExpired, ValueError):
                pass
        shutil.rmtree(d, ignore_errors=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="host_chaos_demo",
        description="seeded mid-scenario host-domain loss through the "
                    "multi-host plane + supervisor")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--stripe", type=int, default=2048)
    ap.add_argument("--objects", type=int, default=2,
                    help="damaged objects recovery must heal")
    ap.add_argument("--erasures", type=int, default=1,
                    help="shards erased per damaged object")
    ap.add_argument("--churn", type=int, default=2,
                    help="churn-storm event budget")
    ap.add_argument("--fault", default="host_loss",
                    choices=["host_loss", "host_flap",
                             "host_partition"],
                    help="the host fault kind to inject")
    ap.add_argument("--host", type=int, default=1,
                    help="which fault domain the adversary takes")
    ap.add_argument("--hosts", type=int, default=2,
                    help="fault domains the armed plane is carved "
                         "into")
    ap.add_argument("--seam", default="engine.fused_repair")
    ap.add_argument("--at", type=int, default=2,
                    help="the seam's Nth poll the fault first fires "
                         "on (2 = after warm-up)")
    ap.add_argument("--calls", type=int, default=0,
                    help="faulted-poll window (0 = persistent until "
                         "the client stream drains)")
    ap.add_argument("--kill-one", action="store_true",
                    help="two-process mode: SIGKILL a real peer "
                         "process mid-batch instead of simulating "
                         "the loss in-process")
    ap.add_argument("--batches", type=int, default=8,
                    help="(kill-one) repair batches per worker")
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)  # internal: subprocess rank
    ap.add_argument("--dir", default=None,
                    help=argparse.SUPPRESS)  # internal: rendezvous dir
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="cuda (default) or cpu: the device executor "
                         "and the workers' plane there; host: the host "
                         "executor and numpy batches")
    ap.add_argument("--json", action="store_true", dest="json_out")
    a = ap.parse_args(argv)

    if a.worker is not None:
        if not a.dir:
            print("host_chaos_demo: --worker needs --dir",
                  file=sys.stderr)
            return 1
        return (_survivor_worker(a) if a.worker == 0
                else _victim_worker(a))
    if a.kill_one:
        if a.batches < 4:
            print("host_chaos_demo: --batches must be >= 4 (healthy "
                  "phase + detection + post-quarantine phase)",
                  file=sys.stderr)
            return 1
        return _kill_one_mode(a)
    if (a.requests < 1 or a.objects < 1 or a.erasures < 0
            or a.at < 1 or a.hosts < 2 or not 0 <= a.host):
        print("host_chaos_demo: bad arguments", file=sys.stderr)
        return 1
    return _scenario_mode(a)


if __name__ == "__main__":
    raise SystemExit(main())
