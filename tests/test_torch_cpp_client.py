"""The C++ client library (native/client) against the port's control
plane: tests/test_cpp_client.py's three cases (the JSON client end to
end, enforced auth, the binary protobuf wire) compiled from their source
with their `armada_tpu` imports pointed at the port, so they drive the
port's ControlPlane (its kernel backend on the CPU), RestGateway and
ApiServer. The demo binaries are built from native/client's sources in a
copy under a temporary directory, never in native/client, where
tests/test_cpp_client.py builds its own. A case skips where the
reference's skips: no C++ toolchain, or no protoc."""

import pathlib
import shutil

import pytest
import torch_cpu  # noqa: F401

from torch_conformance import case_names
from torch_control_plane import _call_case, port_copy

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = case_names(port_copy("test_cpp_client"))


@pytest.fixture(scope="module")
def client_dir(tmp_path_factory):
    """native/client's sources and proto/armada.proto, laid out as in the
    repository (the Makefile reads ../../proto), with nothing built."""
    root = tmp_path_factory.mktemp("cpp-client")
    shutil.copytree(
        ROOT / "native" / "client", root / "native" / "client",
        ignore=shutil.ignore_patterns("*.o", "*.a", "client_demo", "proto_demo", "armada.pb.*"),
    )
    (root / "proto").mkdir()
    shutil.copy(ROOT / "proto" / "armada.proto", root / "proto" / "armada.proto")
    return root / "native" / "client"


def test_every_case_is_collected():
    assert CASES == ["test_cpp_client_end_to_end", "test_cpp_client_proto_wire_format",
                     "test_rest_gateway_auth_enforced"]


@pytest.mark.parametrize("test", CASES)
def test_cpp_client_case_on_port(test, client_dir, monkeypatch, tmp_path):
    import armada_tpu_torch.device as port_device

    module = port_copy("test_cpp_client")
    monkeypatch.setattr(module, "CLIENT_DIR", client_dir)
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    assert module.ControlPlane.__module__ == "armada_tpu_torch.services.server"
    assert module.RestGateway.__module__ == "armada_tpu_torch.services.rest_gateway"
    _call_case(module, getattr(module, test), (), tmp_path, {})
