"""The port's authentication and authorization
(armada_tpu_torch/services/auth.py) against the JAX package's, on the
CPU.

The cases of tests/test_auth.py that need no gRPC server (basic auth,
HS256 tokens, the authenticator chain, the Authorizer, and, where
`cryptography` is installed, RS256 tokens against a JWKS and its file
rotation) run side by side on both packages
(`torch_control_plane.run_side_by_side`), each case's own assertions
holding on both; the port's copy leaves out the reference module's
imports of its gRPC server and query API, which no such case uses.

Direct twins, each exact: the same inputs give the same token strings,
principals and errors, and the Authorizer the same decision for every
principal, verb and queue grant of a grid.
"""

import base64
import importlib
import itertools

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import run_side_by_side

SERVED = ("served",)  # the reference's fixture of a live gRPC server
PORT_SUBS = (
    (r"from armada_tpu_torch\.services\.grpc_api import ApiClient, ApiServer\n", ""),
    (r"from armada_tpu_torch\.services\.queryapi import QueryApi\n", ""),
)
SECRET = "twin-secret"
PACKAGES = ("armada_tpu", "armada_tpu_torch")


def _cases():
    import inspect

    ref = importlib.import_module("test_auth")
    out = []
    for t in sorted(vars(ref)):
        if not t.startswith("test_") or t in ("test_grpc_tls_roundtrip", "test_rest_gateway_tls"):
            continue
        if not SERVED[0] in inspect.signature(getattr(ref, t)).parameters:
            out.append(t)
    return out


CASES = _cases()


def test_every_auth_case_is_collected():
    assert CASES == [
        "test_authorizer_global_and_queue", "test_basic_auth", "test_jwks_file_rotation",
        "test_jwks_rs256_roundtrip_and_failures", "test_multi_auth_first_match_wins",
        "test_token_auth_roundtrip_and_expiry",
    ]


@pytest.mark.parametrize("test", CASES)
def test_auth_case_matches_reference(test, monkeypatch, tmp_path):
    run_side_by_side("test_auth", test, monkeypatch, tmp_path, port_subs=PORT_SUBS)


def _auth(pkg):
    return importlib.import_module(f"{pkg}.services.auth")


def _outcome(fn, *a, **k):
    """What a call gives, comparable across packages: its value (a
    Principal as its fields) or the error's class name and message."""
    try:
        got = fn(*a, **k)
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("raise", type(e).__name__, str(e))
    if hasattr(got, "groups"):
        return ("principal", got.name, sorted(got.groups), got.auth_method)
    return ("value", got)


def _basic(name, password):
    return {"authorization": "Basic " + base64.b64encode(f"{name}:{password}".encode()).decode()}


def _metadata_grid(A):
    good = A.make_token(SECRET, "bob", groups=["ops", "devs"], exp=4.0e9)
    return [
        {},
        {"authorization": "Bearer " + good},
        {"authorization": "Bearer " + A.make_token(SECRET, "bob", exp=1.0)},
        {"authorization": "Bearer " + A.make_token("other", "bob")},
        {"authorization": "Bearer " + A.make_token(SECRET, "eve", iss="elsewhere")},
        {"authorization": "Bearer " + good[:-4] + "AAAA"},
        {"authorization": "Bearer not.a-token"},
        {"authorization": "Bearer onlyonepart"},
        _basic("alice", "pw"),
        _basic("alice", "wrong"),
        _basic("nobody", "pw"),
        {"authorization": "Basic !!!"},
    ]


def test_tokens_and_authenticators_equal_reference():
    """make_token gives the same string on both packages, and BasicAuth,
    TokenAuth, AnonymousAuth and MultiAuth chains give the same
    principal or error for every credential of the grid."""
    got = {}
    for pkg in PACKAGES:
        A = _auth(pkg)
        users = {"alice": {"password": "pw", "groups": ["devs"]}}
        chains = {
            "basic": A.BasicAuth(users),
            "token": A.TokenAuth(SECRET),
            "anonymous": A.AnonymousAuth(),
            "multi": A.MultiAuth([A.BasicAuth(users), A.TokenAuth(SECRET)]),
            "multi_anonymous": A.MultiAuth([A.TokenAuth(SECRET), A.AnonymousAuth()]),
        }
        tokens = [A.make_token(SECRET, "bob", groups=("ops",), exp=4.0e9, iss=iss)
                  for iss in ("armada-tpu", "x")]
        got[pkg] = (tokens, {name: [_outcome(auth.authenticate, md) for md in _metadata_grid(A)]
                             for name, auth in chains.items()})
    assert got["armada_tpu_torch"] == got["armada_tpu"]
    decided = got["armada_tpu"][1]["multi"]
    assert ("principal", "bob", ["devs", "ops"], "token") in decided
    assert any(o[0] == "raise" for o in decided)


def test_authorizer_decisions_equal_reference():
    """Every principal, verb and queue grant of a grid: the global
    decision and the queue decision of the port's Authorizer are the
    reference's (allowed, or the same PermissionDenied)."""
    got = {}
    for pkg in PACKAGES:
        A = _auth(pkg)
        types_ = importlib.import_module(f"{pkg}.core.types")
        az = A.Authorizer(permission_groups={
            A.SUBMIT_ANY_JOBS: ["submitters"], A.CANCEL_ANY_JOBS: ["cancellers"],
            A.CREATE_QUEUE: ["admin"], A.WATCH_ALL_EVENTS: ["everyone"],
        })
        principals = [
            A.Principal("root", frozenset({"admin"})),
            A.Principal("s", frozenset({"submitters"})),
            A.Principal("c", frozenset({"cancellers", "teammates"})),
            A.Principal("owner-user"),
            A.Principal("t", frozenset({"teammates"})),
            A.Principal("r"),
            A.ANONYMOUS,
        ]
        verbs = [A.SUBMIT_ANY_JOBS, A.CREATE_QUEUE, A.DELETE_QUEUE, A.CANCEL_ANY_JOBS,
                 A.REPRIORITIZE_ANY_JOBS, A.WATCH_ALL_EVENTS, A.EXECUTE_JOBS, A.CORDON]

        class Q:
            owners = ("owner-user",)
            permissions = (A.QueuePermission(subjects=("teammates",), verbs=("submit", "watch")),
                           A.QueuePermission(subjects=("s",), verbs=("cancel",)))
            spec = types_.QueueSpec("team")

        rows = []
        for p, verb in itertools.product(principals, verbs):
            rows.append(("global", p.name, verb, _outcome(az.authorize_global, p, verb)))
        for p, queue_verb, verb in itertools.product(
                principals, A.QUEUE_VERBS, (A.SUBMIT_ANY_JOBS, A.CANCEL_ANY_JOBS)):
            rows.append(("queue", p.name, queue_verb, verb,
                         _outcome(az.authorize_queue, p, queue_verb, Q(), verb)))
        got[pkg] = rows
    assert got["armada_tpu_torch"] == got["armada_tpu"]
    outcomes = {r[-1][0] for r in got["armada_tpu"]}
    assert outcomes == {"value", "raise"}


def test_rs256_tokens_and_jwks_equal_reference():
    """With `cryptography`: one RSA key's JWKS, RS256 tokens (signed
    deterministically, PKCS#1 v1.5) and their verdicts are equal on both
    packages, the other package's token included."""
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    other = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    got, tokens = {}, {}
    for pkg in PACKAGES:
        A = _auth(pkg)
        tokens[pkg] = [
            A.make_rs256_token(key, "alice", groups=("devs",), kid="k", exp=4.0e9),
            A.make_rs256_token(key, "alice", kid="k", exp=1.0),
            A.make_rs256_token(key, "alice", kid="k", iss="other"),
            A.make_rs256_token(other, "alice", kid="k"),
            A.make_rs256_token(key, "alice", kid="unknown"),
        ]
    for pkg in PACKAGES:
        A = _auth(pkg)
        auth = A.JwksTokenAuth(jwks=A.jwks_of(key.public_key(), kid="k"))
        got[pkg] = (A.jwks_of(key.public_key(), kid="k"), tokens[pkg],
                    [_outcome(auth.authenticate, {"authorization": f"Bearer {t}"})
                     for ts in tokens.values() for t in ts])
    assert got["armada_tpu_torch"] == got["armada_tpu"]
    assert got["armada_tpu"][2][0] == ("principal", "alice", ["devs"], "jwks")
