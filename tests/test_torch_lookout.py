"""Port copies of the JAX package's Lookout and query-side tests, run side
by side on both packages (`torch_control_plane.run_side_by_side`): each
case's own assertions hold on both, and the leases after every cycle of
every scheduler service are equal.

- tests/test_lookout.py, all 11 cases: the in-memory Lookout view
  (armada_tpu_torch/services/lookout_ingester.py), the query API
  (services/queryapi.py), the HTTP surface and UI
  (services/lookout_http.py, lookout_ui.py), the UI's mutations and its
  log fetch through binoculars (services/binoculars.py);
- tests/test_lookout_sqlite.py, all 4 cases: the SQLite view
  (services/lookout_sqlite.py) against the in-memory one, restart
  without replay, the pruner, and the broadside load bench's SQLite
  backend (clients/broadside.py);
- tests/test_categorizer.py, both cases: the error categoriser, into the
  job database and the query API;
- tests/test_ingest_pipeline.py's event-index cases: the per-jobset
  event-stream index (services/event_index.py) over the ingest pipeline
  (`test_watch_uses_index_end_to_end` needs the gRPC control plane);
- tests/test_slo.py's two Lookout cases: GET /api/slo, and its 503 with
  no tracker attached;
- tests/test_common_infra.py::test_background_task_manager
  (utils/tasks.py).

The JAX package's services default to the host oracle and the port's to
its kernel, so a case that names no backend holds the port's kernel on
the CPU to the JAX package's oracle.
"""

import importlib

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import run_side_by_side


def _all(name):
    return [(name, t) for t in sorted(vars(importlib.import_module(name)))
            if t.startswith("test_")]


CASES = (
    _all("test_lookout")
    + [("test_lookout_sqlite", t) for t in (
        "test_differential_vs_in_memory", "test_restart_without_replay", "test_pruner",
        "test_broadside_sqlite_backend_smoke")]
    + _all("test_categorizer")
    + [("test_ingest_pipeline", t) for t in (
        "test_event_index_partitions_streams", "test_event_index_idempotent_replay",
        "test_event_index_retention_prune",
        "test_event_index_pruned_then_recreated_jobset_defers_to_log")]
    + [("test_slo", t) for t in (
        "test_lookout_api_slo_endpoint", "test_lookout_api_slo_503_when_detached")]
    + [("test_common_infra", "test_background_task_manager")]
)


def test_case_list_is_whole():
    """Every case of the reference's Lookout files is here but the ones
    the module docstring names as waiting for the server or a client."""
    assert len(_all("test_lookout")) == 11 and len(_all("test_categorizer")) == 2
    waiting = {("test_ingest_pipeline", "test_watch_uses_index_end_to_end")}
    for name in ("test_lookout_sqlite",):
        assert set(_all(name)) - set(CASES) == {c for c in waiting if c[0] == name}
    index = {c for c in _all("test_ingest_pipeline") if "index" in c[1]}
    assert index - set(CASES) == {c for c in waiting if c[0] == "test_ingest_pipeline"}


@pytest.mark.parametrize("name,test", CASES, ids=[f"{n}::{t}" for n, t in CASES])
def test_lookout_case_matches_reference(name, test, monkeypatch, tmp_path):
    run_side_by_side(name, test, monkeypatch, tmp_path)
