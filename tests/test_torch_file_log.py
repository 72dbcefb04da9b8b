"""The port's file-backed event log (armada_tpu_torch/events/file_log.py,
and services/chaos.py's CrashRecoveringLog) against the JAX package's,
on the CPU.

Every case of tests/test_file_log.py runs side by side on both packages
(`torch_control_plane.run_side_by_side`): each case's own assertions
hold on both, and the leases after every cycle of any scheduler service
are equal. Each case writes its logs under a directory of its own per
package, with the wall clock held at one instant (control-plane events
such as a queue's creation stamp it); after it, the two directories
hold the same files with the same bytes (the codec writes the same
records: the same event classes and field names, the same crc), and
opening each log directory again with its package's FileEventLog
recovers equal entries, or refuses with the same error.

Direct twins: one history of events of every kind, with a torn tail and
a rollover, written by both packages' FileEventLog, gives byte-equal
segments; each package reads the other's directory back to the same
entries.
"""

import importlib
import os
import time

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import PORT, REF, plain, run_side_by_side


def _cases():
    ref = importlib.import_module("test_file_log")
    return [t for t in sorted(vars(ref)) if t.startswith("test_")]


CASES = _cases()
WALL_CLOCK = 1_700_000_000.0


def test_every_file_log_case_is_collected():
    assert len(CASES) == 11


def _files(root):
    """relative path -> bytes of every file under `root`."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _recovered(pkg, directory):
    """The entries a fresh FileEventLog of package `pkg` recovers from
    `directory`, in plain form, or the error it refuses with."""
    file_log = importlib.import_module(f"{pkg}.events.file_log")
    try:
        log = file_log.FileEventLog(str(directory))
    except Exception as e:  # noqa: BLE001 - the refusal is the result
        return ("refused", type(e).__name__, str(e).replace(str(directory), "<dir>"))
    try:
        return ("entries", log.start_offset, plain(log.read(log.start_offset, 10**9)))
    finally:
        log.close()


@pytest.mark.parametrize("test", CASES)
def test_file_log_case_matches_reference(test, monkeypatch, tmp_path):
    monkeypatch.setattr(time, "time", lambda: WALL_CLOCK)
    run_side_by_side("test_file_log", test, monkeypatch, tmp_path)
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert ref_files, test
    assert port_files.keys() == ref_files.keys()
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    logs = sorted({os.path.dirname(n) for n in ref_files if os.path.basename(n).startswith("seg-")})
    assert logs, test
    for rel in logs:
        ref = _recovered("armada_tpu", tmp_path / "ref" / rel)
        port = _recovered("armada_tpu_torch", tmp_path / "port" / rel)
        assert port == ref, rel


def _history(P):
    """Sequences of every event kind the control plane writes, one job
    with every JobSpec field the codec carries."""
    ev = P.events
    types_ = importlib.import_module(f"{P.name}.core.types")
    spec = P.JobSpec(
        id="j-full", queue="q", jobset="s", priority=3, priority_class="d",
        requests={"cpu": "2", "memory": "1Gi"}, node_selector={"zone": "a"},
        tolerations=(types_.Toleration(key="k", value="v"),),
        affinity=types_.Affinity(terms=(types_.NodeSelectorTerm(expressions=(
            types_.MatchExpression(key="zone", operator="In", values=("a", "b")),)),)),
        gang=P.Gang(id="g", cardinality=2), submitted_ts=1.5,
        annotations={"a": "b"}, bid_prices={"p": 1.25}, command=("run", "x"),
    )
    seqs = [
        ev.EventSequence.of("q", "s", ev.SubmitJob(created=1.0, job=spec)),
        ev.EventSequence.of("q", "s", ev.JobRunLeased(
            created=2.0, job_id="j-full", run_id="r1", executor="e", node_id="n",
            pool="p", scheduled_at_priority=1000)),
        ev.EventSequence.of("q", "s", ev.JobRunRunning(created=3.0, job_id="j-full",
                                                       run_id="r1")),
        ev.EventSequence.of("q", "s", ev.JobRunPreempted(
            created=4.0, job_id="j-full", run_id="r1", reason="drain", requeue=True)),
        ev.EventSequence.of("q", "s", ev.ReprioritiseJob(created=5.0, job_id="j-full",
                                                         priority=7)),
        ev.EventSequence.of("q", "s", ev.CancelJob(created=6.0, job_id="j-full")),
    ]
    for i in range(6):
        seqs.append(ev.EventSequence.of("q", f"s{i % 2}", ev.SubmitJob(
            created=10.0 + i,
            job=P.JobSpec(id=f"j{i}", queue="q", jobset=f"s{i % 2}",
                          requests={"cpu": "1"}, submitted_ts=float(i)))))
    return seqs


def test_written_segments_are_byte_equal_and_read_across(tmp_path):
    """Both packages write byte-equal segments (rollover every 4
    records, a torn tail cut after the last record), recover them to
    equal entries, and each reads the other's directory."""
    dirs = {}
    for P in (REF, PORT):
        file_log = importlib.import_module(f"{P.name}.events.file_log")
        d = tmp_path / P.name
        log = file_log.FileEventLog(str(d), segment_size=4)
        for seq in _history(P):
            log.publish(seq)
        log.close()
        segs = sorted(n for n in os.listdir(d) if n.startswith("seg-"))
        with open(d / segs[-1], "ab") as f:
            f.write(b'{"o": 12, "c": 1, "s": {"q"')
        dirs[P.name] = d
    assert _files(dirs["armada_tpu_torch"]) == _files(dirs["armada_tpu"])
    got = {pkg: _recovered(pkg, d) for pkg, d in dirs.items()}
    assert got["armada_tpu_torch"] == got["armada_tpu"]
    assert got["armada_tpu"][0] == "entries" and len(got["armada_tpu"][2]) == 12
    assert _recovered("armada_tpu_torch", dirs["armada_tpu"]) == got["armada_tpu"]
    assert _recovered("armada_tpu", dirs["armada_tpu_torch"]) == got["armada_tpu"]


def test_crash_recovering_log_equals_reference(tmp_path):
    """A CrashRecoveringLog under the same torn-write plan crashes as
    often on both packages, leaves the same bytes, and its compaction
    leaves the same files and offsets."""
    out = {}
    for P in (REF, PORT):
        chaos = importlib.import_module(f"{P.name}.services.chaos")
        plan = P.FaultPlan([P.FaultSpec("torn_log_write", "*", start=0.0, count=4,
                                        param=0.3)])
        d = tmp_path / P.name
        log = chaos.CrashRecoveringLog(str(d), plan, clock=lambda: 1.0, segment_size=3)
        for seq in _history(P):
            log.publish(seq)
        removed = log.compact(7)
        state = (log.crashes, removed, log.start_offset, log.end_offset)
        log.close()
        out[P.name] = (state, _files(d), _recovered(P.name, d))
    assert out["armada_tpu_torch"] == out["armada_tpu"]
    assert out["armada_tpu"][0][0] == 4
