"""The port's clients, CLIs and testsuite (armada_tpu_torch/clients/,
sim/cli.py, testsuite/, tools/policy_ab.py, gen_metrics_doc.py and
gen_known_gaps.py) against the JAX package's, on the CPU.

- Port copies of tests/test_testsuite.py (its eight `CASES`, the
  preemption case, `detects_failure`, the load tester, broadside over the
  server and the simulator CLI), each run on one module-scoped port plane,
  tests/test_testsuite.py's own fixture with `device="cpu"`; the JAX
  package's plane is built by the same fixture for the cross-package
  cases.
- tests/test_broadside.py's four cases side by side on both packages
  (`torch_control_plane.run_side_by_side`), and tests/test_aio_client.py
  on the port's plane, with the JAX package's asyncio client beside the
  port's: the same calls, the same replies.
- test_fairness.py::test_fairness_report_rpc_lookout_and_cli and
  test_slo.py::test_slo_status_rpc_and_armadactl side by side.
- armadactl across packages over gRPC: the port's CLI against the JAX
  package's server and the JAX package's CLI against the port's, one
  session of commands each, equal output once job ids and submit times
  are mapped.
- The simulator CLI's `--json` result equal to the JAX package's on the
  same files, on either backend.
- The tools: `gen_known_gaps` renders what the repo's tool renders;
  `gen_metrics_doc` renders the port's registry with the repo's renderer,
  equal to the repo's render but the help text of the families the port's
  metrics word for its own device; the `policy_ab` CLI's and armadactl
  `policy ab`'s `--json` equal the port's `ab_compare` on the committed
  fixture (tests/test_torch_trace_cross.py holds its scorecards to the
  reference).
- chip_smoke.py phase 18 on the CPU at 4,000 jobs on 1,500 nodes (the
  launch counts stubbed: CPU wrappers count none), and its testsuite specs
  equal to testsuite_cases/*.yaml.
"""

import asyncio
import importlib
import inspect
import json
import os
import re
import sys
import time

import pytest
import torch_cpu  # noqa: F401
import yaml

from torch_control_plane import port_copy, run_side_by_side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "sim_steady.atrace")

# tests/test_testsuite.py with its plane on the CPU and the simulator CLI
# told the CPU (the port's solve on the card otherwise).
TESTSUITE_SUBS = (
    (r"(    p = ControlPlane\(\n        config,\n)", r'\1        device="cpu",\n'),
    (r'(main\(\["--clusters", str\(cluster\), "--workload", str\(workload\), "--json")\]\)',
     r'\1, "--device", "cpu"])'),
)
REF_TS = importlib.import_module("test_testsuite")
PORT_TS = port_copy("test_testsuite", TESTSUITE_SUBS)


# The side-by-side cases come first: they record every scheduler cycle
# of the process, and the planes below cycle on threads of their own
# from their first test on.
BROADSIDE = ("test_opstats_reset_and_snapshot", "test_inproc_backend_lifecycle_mix",
             "test_runner_report_shape", "test_overlapping_fractions_stay_disjoint")


@pytest.mark.parametrize("test", BROADSIDE)
def test_broadside_case_matches_reference(test, monkeypatch, tmp_path):
    run_side_by_side("test_broadside", test, monkeypatch, tmp_path)


def test_broadside_case_list_is_whole():
    ref = importlib.import_module("test_broadside")
    assert {t for t in vars(ref) if t.startswith("test_")} == set(BROADSIDE)


CLI_CASES = (("test_fairness", "test_fairness_report_rpc_lookout_and_cli"),
             ("test_slo", "test_slo_status_rpc_and_armadactl"))


@pytest.mark.parametrize("name,test", CLI_CASES, ids=[f"{n}::{t}" for n, t in CLI_CASES])
def test_cli_case_matches_reference(name, test, monkeypatch, tmp_path, capsys):
    run_side_by_side(name, test, monkeypatch, tmp_path,
                     given=({"capsys": capsys}, {"capsys": capsys}))


def _fixture_value(fixture):
    gen = fixture._get_wrapped_function()()
    return gen, next(gen)


@pytest.fixture(scope="module")
def planes():
    """{"ref": the JAX package's plane, "port": the port's}, each
    tests/test_testsuite.py's `plane`."""
    gens, out = [], {}
    try:
        for key, mod in (("ref", REF_TS), ("port", PORT_TS)):
            gen, out[key] = _fixture_value(mod.plane)
            gens.append(gen)
        yield out
    finally:
        for gen in reversed(gens):
            next(gen, None)


@pytest.fixture
def port_plane(planes):
    return planes["port"]


# ---- armadactl across packages ----

SESSION_JOBS = """
queue: xq
jobSetId: xs
jobs:
  - priority: 0
    count: 3
    requests:
      cpu: "999"
      memory: 1Gi
"""


def _cli_session(main, plane, tmp_path, capsys):
    """armadactl's `main` through one session against `plane`'s gRPC
    server: queue CRUD, a submit of three jobs no node fits (they stay
    queued on either backend), their rows and events, a reprioritise and
    a cancel, an unknown queue (the error path) and the queue's delete.
    Returns each command's (stdout, stderr, exit code), job ids as their
    submission index (rows in that order) and clock times as "<t>"."""
    tmp_path.mkdir()
    jobs = tmp_path / "jobs.yaml"
    jobs.write_text(SESSION_JOBS)

    def run(*argv):
        code = 0
        try:
            main(["--server", plane.address, *argv])
        except SystemExit as e:
            code = e.code
        out, err = capsys.readouterr()
        return out, err, code

    def wait(pred):
        deadline = time.time() + 30
        while time.time() < deadline and not pred():
            time.sleep(0.05)
        assert pred()

    db = plane.scheduler.jobdb
    got = [run("queue", "create", "xq", "--priority-factor", "3"),
           run("queue", "get", "xq"),
           run("queue", "update", "xq", "--priority-factor", "2"),
           run("queue", "get", "xq")]
    got.append(run("submit", str(jobs)))
    ids = got[-1][0].split()
    assert len(ids) == 3
    wait(lambda: all(db.get(j) is not None for j in ids))
    got += [run("jobs", "--queue", "xq", "--take", "10"),
            run("watch", "xq", "xs", "--no-follow"),
            run("reprioritize", "--queue", "xq", "--jobset", "xs", "--job-id", ids[1],
                "--priority", "5"),
            run("cancel", "--queue", "xq", "--jobset", "xs", "--job-id", ids[0])]
    wait(lambda: db.get(ids[0]).state.value == "cancelled" and db.get(ids[1]).priority == 5)
    got += [run("jobs", "--queue", "xq", "--state", "queued"),
            run("queue", "get", "no-such-queue"),
            run("queue", "delete", "xq")]
    names = {jid: f"job#{k}" for k, jid in enumerate(ids)}

    def canon(text):
        try:
            doc = json.loads(text)
        except ValueError:
            doc = None
        if isinstance(doc, dict) and "jobs" in doc:
            # Rows of one submit share its time; the ids, drawn at
            # random, break the tie.
            doc["jobs"].sort(key=lambda r: names[r["job_id"]])
            text = json.dumps(doc, indent=2)
        text = re.sub(r"\bjob-[0-9a-z]{26}\b", lambda m: names.get(m.group(0), "<job>"), text)
        return re.sub(r"\b\d{10}\.\d+\b", "<t>", text)

    # Standard error: the CLI's own lines (the planes' threads may log
    # there too).
    return [(canon(out), canon("".join(ln for ln in err.splitlines(True)
                                       if ln.startswith("error: "))), code)
            for out, err, code in got]


def test_cli_across_packages_over_grpc(planes, tmp_path, capsys):
    """The port's armadactl against the JAX package's server and the JAX
    package's against the port's: the same session prints the same."""
    from armada_tpu.clients.cli import main as ref_main
    from armada_tpu_torch.clients.cli import main as port_main

    port_on_ref = _cli_session(port_main, planes["ref"], tmp_path / "a", capsys)
    ref_on_port = _cli_session(ref_main, planes["port"], tmp_path / "b", capsys)
    assert port_on_ref == ref_on_port
    assert port_on_ref[-2][2] == 1 and port_on_ref[-2][1].startswith("error: ")
    assert '"total": 3' in port_on_ref[5][0] and '"total": 2' in port_on_ref[9][0]


def test_cli_raises_a_foreign_error_as_it_is(monkeypatch):
    """armadactl's error handler names gRPC's RpcError without importing
    grpc: where no client reached a socket, another error is raised as
    it is."""
    from armada_tpu_torch.clients import cli

    class Broken:
        def list_queues(self):
            raise KeyError("boom")

    monkeypatch.setattr(cli, "connect", lambda server, ca_cert=None, token=None: Broken())
    with pytest.raises(KeyError, match="boom"):
        cli.main(["queue", "list"])


# ---- the testsuite, the load tester, broadside and the simulator CLI ----


@pytest.mark.parametrize("case", REF_TS.CASES)
def test_testsuite_case_on_port(port_plane, case):
    PORT_TS.test_testsuite_case(port_plane, case)


def test_testsuite_preemption_on_port(port_plane):
    PORT_TS.test_testsuite_preemption(port_plane)


def test_testsuite_detects_failure_on_port(port_plane, tmp_path):
    PORT_TS.test_testsuite_detects_failure(port_plane, tmp_path)


def test_load_tester_on_port(port_plane, capsys):
    PORT_TS.test_load_tester(port_plane, capsys)


def test_broadside_on_port(port_plane, capsys):
    PORT_TS.test_broadside(port_plane, capsys)


def test_simulator_cli_on_port(tmp_path, capsys):
    PORT_TS.test_simulator_cli(tmp_path, capsys)


def test_testsuite_specs_match_reference(tmp_path):
    """Every testsuite case file parses to the same spec and the same
    submit groups in both packages."""
    from armada_tpu.testsuite import runner as ref_runner
    from armada_tpu_torch.testsuite import runner

    for name in sorted(os.listdir(os.path.join(REPO, "testsuite_cases"))):
        with open(os.path.join(REPO, "testsuite_cases", name)) as f:
            doc = yaml.safe_load(f)
        spec, ref_spec = runner.TestSpec.from_dict(doc), ref_runner.TestSpec.from_dict(doc)
        assert vars(spec) == vars(ref_spec), name
        assert runner._expand_groups(spec) == ref_runner._expand_groups(ref_spec), name


def test_async_client_on_port_matches_reference(port_plane):
    """tests/test_aio_client.py's case on the port's plane, then the
    same reads through the JAX package's asyncio client and the port's:
    the same replies."""
    from armada_tpu.clients.aio import AsyncApiClient as RefClient
    from armada_tpu_torch.clients.aio import AsyncApiClient

    port_copy("test_aio_client").test_async_client_end_to_end(port_plane)
    jobs = [j for j in port_plane.scheduler.jobdb.read_txn().all_jobs() if j.queue == "aq"]
    deadline = time.time() + 30
    while time.time() < deadline and not all(j.state.value in ("cancelled", "succeeded")
                                             for j in jobs):
        time.sleep(0.05)
        jobs = [port_plane.scheduler.jobdb.get(j.id) for j in jobs]
    assert len(jobs) == 2 and {j.state.value for j in jobs} == {"cancelled", "succeeded"}

    async def reads(cls):
        client = cls(port_plane.address)
        try:
            return (await client.get_queue("aq"), await client.list_queues(),
                    await client.get_jobs(filters=[{"field": "queue", "value": "aq"}], take=10),
                    await client.group_jobs("state", filters=[{"field": "queue", "value": "aq"}]),
                    [e async for e in client.watch_jobset("aq", "ajs", watch=False)])
        finally:
            await client.close()

    assert asyncio.run(reads(AsyncApiClient)) == asyncio.run(reads(RefClient))


SIM_CLUSTER = """
name: c1
nodeTemplates:
  - count: 4
    cpu: "16"
    memory: 64Gi
  - count: 2
    cpu: "8"
    memory: 32Gi
    labels: {zone: z2}
"""
SIM_WORKLOAD = """
queues:
  - name: qa
    jobTemplates:
      - id: t
        number: 30
        cpu: "2"
        memory: 1Gi
        runtimeMinimum: 30
        runtimeTailMean: 20
  - name: qb
    priorityFactor: 2.0
    jobTemplates:
      - id: g
        number: 8
        cpu: "4"
        memory: 2Gi
        gangCardinality: 4
        runtimeMinimum: 60
        submitTime: 15
"""


@pytest.mark.parametrize("backend", ["oracle", "kernel"])
def test_simulator_cli_json_matches_reference(backend, tmp_path, capsys):
    """The port's simulator CLI prints the JAX package's `--json`
    result on the same files but the wall seconds: its oracle against
    the reference's, its kernel on the CPU against the reference's oracle
    (the JAX package's default)."""
    from armada_tpu.sim.cli import main as ref_main
    from armada_tpu_torch.sim.cli import main

    cluster, workload = tmp_path / "cluster.yaml", tmp_path / "workload.yaml"
    cluster.write_text(SIM_CLUSTER)
    workload.write_text(SIM_WORKLOAD)
    files = ["--clusters", str(cluster), "--workload", str(workload), "--json", "--seed", "3"]
    assert ref_main(files) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(files + ["--backend", backend, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("wall_s") >= 0 and want.pop("wall_s") >= 0
    assert got == want and got["finished_jobs"] == 38


# ---- the tools ----


def _repo_tool(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", os.path.join(REPO, "tools",
                                                                             f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_gen_known_gaps_renders_as_the_repo_tool(capsys):
    from armada_tpu_torch.tools import gen_known_gaps

    ref = _repo_tool("gen_known_gaps")
    assert (gen_known_gaps.YAML_PATH, gen_known_gaps.DOC_PATH) == (ref.YAML_PATH, ref.DOC_PATH)
    assert gen_known_gaps.render(gen_known_gaps.load_gaps()) == ref.render(ref.load_gaps())
    assert gen_known_gaps.main(["--check"]) == 0
    assert gen_known_gaps.main([]) == 0
    assert capsys.readouterr().out == ref.render(ref.load_gaps()) + "\n"


# The families whose help text the port's services/metrics.py words for its
# own device (CUDA paths, nvcc builds) where the JAX package's names XLA.
DEVICE_WORDED = ("scheduler_solve_kernel_info", "scheduler_xla_cache_events",
                 "scheduler_xla_compile_seconds", "scheduler_xla_compiles",
                 "scheduler_xla_retraces")


def test_gen_metrics_doc_renders_as_the_repo_tool(monkeypatch, capsys):
    from armada_tpu_torch.services.metrics import HAVE_PROMETHEUS
    from armada_tpu_torch.tools import gen_metrics_doc

    if not HAVE_PROMETHEUS:
        pytest.skip("prometheus_client unavailable")
    ref = _repo_tool("gen_metrics_doc")
    assert gen_metrics_doc.DOC_PATH == ref.DOC_PATH and gen_metrics_doc.HEADER == ref.HEADER
    got, want = gen_metrics_doc.families(), ref.families()
    assert [r[:3] for r in got] == [r[:3] for r in want]
    assert {r[0] for r, w in zip(got, want) if r != w} == set(DEVICE_WORDED)
    # The repo's renderer over the port's families is the port's render.
    monkeypatch.setattr(ref, "families", gen_metrics_doc.families)
    assert ref.render() == gen_metrics_doc.render()
    assert gen_metrics_doc.main([]) == 0
    assert capsys.readouterr().out == gen_metrics_doc.render()


AB_ARGS = ["--policy", "drf", "--policy", "proportional", "--solver", "lax",
           "--allow-foreign", "--device", "cpu", "--json"]


def test_policy_ab_clis_print_ab_compare(capsys):
    """The port's policy_ab tool and armadactl `policy ab` print the
    port's `ab_compare` document for the committed fixture; an unusable
    bundle exits 2."""
    from armada_tpu_torch.clients import cli
    from armada_tpu_torch.tools import policy_ab
    from armada_tpu_torch.trace.policy_ab import ab_compare

    want = json.loads(json.dumps(ab_compare([FIXTURE], ("drf", "proportional"), solver="lax",
                                            allow_foreign=True, device="cpu")))
    assert policy_ab.main([FIXTURE] + AB_ARGS) == 0
    assert json.loads(capsys.readouterr().out) == want
    cli.main(["policy", "ab", FIXTURE] + AB_ARGS)
    assert json.loads(capsys.readouterr().out) == want
    assert policy_ab.main([os.path.join(REPO, "README.md"), "--device", "cpu"]) == 2
    assert capsys.readouterr().out.startswith("policy_ab: ")


# ---- chip_smoke.py phase 18 ----


def _smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_phase_clients_specs_are_the_case_files():
    """Phase 18 holds testsuite_cases/*.yaml as dicts (the card has no
    PyYAML): each equal to its file, in tests/test_testsuite.py's order,
    and its impossible spec equal to test_testsuite_detects_failure's."""
    smoke = _smoke()
    assert list(smoke.TESTSUITE_SPECS) == list(REF_TS.CASES) + ["preemption"]
    assert set(smoke.TESTSUITE_SPECS) == {
        n[:-5] for n in os.listdir(os.path.join(REPO, "testsuite_cases"))}
    for case, doc in smoke.TESTSUITE_SPECS.items():
        with open(os.path.join(REPO, "testsuite_cases", f"{case}.yaml")) as f:
            assert yaml.safe_load(f) == doc, case
    src = inspect.getsource(REF_TS.test_testsuite_detects_failure)
    assert yaml.safe_load(src.split('"""')[1]) == smoke.TESTSUITE_IMPOSSIBLE


def test_phase_clients_on_cpu(monkeypatch):
    """Phase 18 at 4,000 jobs on 1,500 nodes on the CPU: every check of
    the phase holds but the launch counts."""
    import armada_tpu_torch.device as port_device

    smoke = _smoke()
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(smoke, "take_launches", lambda totals, label, extra=(): {
        k: 0 for k in totals})
    monkeypatch.setattr(smoke, "BROADSIDE_S", 1.0)
    rec = smoke.phase_clients(n_jobs=4000, n_nodes=1500, device="cpu")
    assert all(s["passed"] for k, s in rec["testsuite"]["specs"].items() if k != "impossible")
    assert not rec["testsuite"]["specs"]["impossible"]["passed"]
    assert rec["load_tester"]["cuda"]["submitted"] == rec["load_tester"]["lax"]["submitted"] == 4000
    assert len(rec["cycles"]) == 3 and all(c[kp]["leased"] for c in rec["cycles"]
                                           for kp in ("cuda", "lax"))
    assert len(rec["commands"]) == 18 and rec["mutation"]["next_cycle_leased"] > 0
    assert {b: rec["broadside"][b]["backend"] for b in rec["broadside"]} == {
        "inproc": "inproc", "sqlite": "sqlite"}
