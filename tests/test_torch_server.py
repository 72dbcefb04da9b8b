"""The port's control plane behind its servers (armada_tpu_torch/services/
server.py `ControlPlane`, grpc_api.py, rest_gateway.py,
executor_agent.py, node_info.py) against the JAX package's, on the CPU.

Port copies, side by side (`torch_control_plane.run_side_by_side`), each
case's own assertions holding on both packages, of the reference's
cases that need a gRPC or REST server or the executor agent:
- tests/test_executor_runtime.py, all 7 (node classification, per-node
  pools through a live server, real-process pods with their rlimits,
  services and ingresses);
- tests/test_checkpoint.py's four cases through its ControlPlane helper
  (`_plane`: the file log, checkpoints and compaction under a restarted
  plane);
- tests/test_auth.py's TLS cases (gRPC and the REST gateway) and its
  three cases behind an authenticating gRPC server;
- tests/test_frontdoor.py's gRPC cases, in their order over one
  overloaded plane per package (the reference's module-scoped fixture):
  shedding with retry-after, the clients' bounded retries on both wires,
  deadline propagation and the front door's Lookout view;
- test_affinity.py::test_affinity_over_grpc,
  test_backpressure.py::test_submission_shed_and_executor_pause,
  test_chaos.py::test_lease_breaker_on_server_lease_path,
  test_ingest_pipeline.py::test_watch_uses_index_end_to_end and
  test_metrics_liveness.py::test_frontdoor_families_live_after_short_soak;
- tests/test_job_journey.py and tests/test_retry_and_cordon.py, all but
  their cases that drive clients/cli.py (ROADMAP A4): the job timeline,
  one trace id from a gRPC submit through the lease to an agent's
  reports, the JobTrace RPC and Lookout's /api/jobtrace; retry node
  anti-affinity and cordoned queues, round and end to end.
The leases after every cycle are compared but where a case's control
plane cycles on the wall clock in a thread of its own (a started
ControlPlane) or the submit service draws its jobs' ids at random.
A ControlPlane with no backend named solves on the port's kernel, on
the CPU here, against the JAX package's host oracle.
"""

import importlib

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import case_marks, port_copy, run_side_by_side

CASES = (
    [("test_executor_runtime", t, t.startswith("test_node_info")) for t in (
        "test_node_info_pool_label_and_reserved_suffix",
        "test_node_info_type_from_label_or_taints",
        "test_per_node_pools_reach_the_scheduler",
        "test_subprocess_pod_runs_real_process",
        "test_subprocess_pod_failure_reports_rc_and_debug",
        "test_subprocess_rlimit_enforces_memory_request",
        "test_services_and_ingresses_share_pod_lifecycle")]
    + [("test_checkpoint", t, True) for t in (
        "test_restart_from_checkpoint_after_compaction",
        "test_kill9_after_checkpoint_replays_only_suffix",
        "test_churn_with_rolling_compaction",
        "test_checkpoint_crash_point_fuzz")]
    + [("test_auth", t, True) for t in (
        "test_grpc_tls_roundtrip", "test_rest_gateway_tls",
        "test_unauthenticated_writes_rejected", "test_permission_denied_without_grant",
        "test_authorized_flow_and_queue_grants")]
    + [("test_affinity", "test_affinity_over_grpc", True),
       ("test_backpressure", "test_submission_shed_and_executor_pause", False),
       ("test_chaos", "test_lease_breaker_on_server_lease_path", True),
       ("test_ingest_pipeline", "test_watch_uses_index_end_to_end", False),
       ("test_metrics_liveness", "test_frontdoor_families_live_after_short_soak", True)]
    + [("test_job_journey", t, c) for t, c in (
        ("test_timeline_aggregates_unschedulable_rounds", True),
        ("test_timeline_bounded_eviction_prefers_terminal_then_leased", True),
        ("test_timeline_entry_cap_keeps_terminal_visible", True),
        ("test_one_trace_id_spans_submit_to_lease_over_grpc", False),
        ("test_job_trace_query_and_lookout_http", False),
        ("test_job_trace_unknown_job_is_not_found", False),
        ("test_round_report_top_reasons_match_job_reason_map", True))]
    + [("test_retry_and_cordon", t, True) for t in (
        "test_excluded_nodes_respected", "test_all_nodes_excluded_blocks",
        "test_cordoned_queue_blocks_new_jobs", "test_e2e_failed_node_retry_avoids_node",
        "test_e2e_cordoned_queue")]
)
# The job timeline counts a job's unschedulable rounds from the host
# oracle's per-job reasons; a kernel round records none, in either package
# (ROADMAP, "Not port faults"). The reference's stuck-job fixture relies on
# its ControlPlane's default backend, the oracle, so the port's copy names
# it.
STUCK = ((r'(ControlPlane\(\n\s+SchedulingConfig\(\),\n)(\s+)(cycle_period=0\.05,\n\s+'
          r'fake_executors=\[\{"name": "small")', r'\1\2backend="oracle",\n\2\3'),)
PORT_SUBS = {("test_job_journey", t): STUCK for t in (
    "test_job_trace_query_and_lookout_http", "test_job_trace_unknown_job_is_not_found")}
# Cases of these files that drive clients/cli.py, which the port has not
# written (ROADMAP A4).
WAITING = {("test_job_journey", "test_job_trace_cli_renders_multiround_history"),
           ("test_retry_and_cordon", "test_cli_node_cordon_respected_by_next_round"),
           ("test_retry_and_cordon", "test_cli_executor_cordon_event_log_round_trip")}
# tests/test_frontdoor.py's cases over its module-scoped overloaded plane,
# in the reference's order (later ones use the queues and sheds of
# earlier ones).
FRONTDOOR = (
    "test_shed_maps_to_resource_exhausted_with_retry_after",
    "test_client_honors_retry_after_with_bounded_backoff",
    "test_proto_client_honors_retry_after",
    "test_client_deadline_propagates_and_drops_early",
    "test_expired_deadline_drops_at_the_gate_over_the_wire",
    "test_lookout_frontdoor_view",
)


def test_case_list_is_whole():
    """The reference's cases that take the server fixture of their file,
    or a ControlPlane, are all here (but the ones ROADMAP A4 holds)."""
    import inspect

    for name in ("test_executor_runtime", "test_job_journey", "test_retry_and_cordon"):
        ref = importlib.import_module(name)
        assert {t for t in vars(ref) if t.startswith("test_")} == {
            t for n, t, _ in CASES if n == name} | {t for n, t in WAITING if n == name}
    checkpoint = importlib.import_module("test_checkpoint")
    assert {t for t in vars(checkpoint) if t.startswith("test_")
            and "_plane(" in inspect.getsource(getattr(checkpoint, t))} == {
        t for n, t, _ in CASES if n == "test_checkpoint"}
    frontdoor = importlib.import_module("test_frontdoor")
    assert [t for t in vars(frontdoor) if t.startswith("test_") and "overloaded_plane" in
            inspect.signature(getattr(frontdoor, t)).parameters] == list(FRONTDOOR)
    auth = importlib.import_module("test_auth")
    assert {t for t in vars(auth) if t.startswith("test_") and (
        "served" in inspect.signature(getattr(auth, t)).parameters or "tls" in t)} == {
        t for n, t, _ in CASES if n == "test_auth"}


def _param(name, test, cycles):
    marks = [m for m in case_marks(name, test) if m.name != "parametrize"]
    return pytest.param(name, test, cycles, marks=marks, id=f"{name}::{test}")


@pytest.mark.parametrize("name,test,cycles", [_param(*c) for c in CASES])
def test_server_case_matches_reference(name, test, cycles, monkeypatch, tmp_path):
    run_side_by_side(name, test, monkeypatch, tmp_path, cycles=cycles,
                     port_subs=PORT_SUBS.get((name, test), ()))


@pytest.fixture(scope="module")
def overloaded_planes():
    """The reference module's overloaded plane and its port copy's, the
    port's solving on the CPU; torn down after the last case."""
    import armada_tpu_torch.device as port_device

    modules = (importlib.import_module("test_frontdoor"), port_copy("test_frontdoor"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_device, "DEFAULT_DEVICE", "cpu")
        gens = [m.overloaded_plane._get_wrapped_function()() for m in modules]
        try:
            yield tuple(next(g) for g in gens)
        finally:
            for g in gens:
                next(g, None)


@pytest.mark.parametrize("test", FRONTDOOR)
def test_frontdoor_grpc_case_matches_reference(test, overloaded_planes, monkeypatch, tmp_path):
    ref, port = overloaded_planes
    assert type(port).__module__ == "armada_tpu_torch.services.server"
    run_side_by_side("test_frontdoor", test, monkeypatch, tmp_path, cycles=False,
                     given=({"overloaded_plane": ref}, {"overloaded_plane": port}))
