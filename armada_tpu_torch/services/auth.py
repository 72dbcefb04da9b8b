"""Authentication + authorization for the API surface.

Mirrors internal/common/auth/{multi.go,basic.go,oidc.go,
permissions.go} and the server's queue-level permission model
(pkg/client/queue permissions): a chain of authenticators resolves a
Principal from call credentials (first success wins, multi.go), and an
Authorizer grants verbs either globally (group -> permission map,
permissions.go) or per queue (queue permission subjects).

The OIDC-shaped authenticator verifies HS256 JWTs self-contained (no
external IdP dependency in this environment); the token layout (sub,
groups, exp, iss) matches what the reference extracts from OIDC claims.

This is the port's copy of the JAX package's services/auth.py.
`cryptography` is imported only where an RS256 token is made or checked
(`JwksTokenAuth`, `make_rs256_token`, `jwks_of`), so the rest works on a
machine without it.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field


class AuthError(Exception):
    """Unauthenticated: no authenticator produced a principal."""


class PermissionDenied(Exception):
    """Authenticated but not allowed."""


@dataclass(frozen=True)
class Principal:
    name: str
    groups: frozenset = frozenset()
    auth_method: str = ""

    def in_any(self, groups) -> bool:
        return bool(self.groups & set(groups)) or self.name in set(groups)


ANONYMOUS = Principal(name="anonymous", auth_method="anonymous")

# Global permission verbs (permissions.go).
SUBMIT_ANY_JOBS = "submit_any_jobs"
CREATE_QUEUE = "create_queue"
DELETE_QUEUE = "delete_queue"
CANCEL_ANY_JOBS = "cancel_any_jobs"
REPRIORITIZE_ANY_JOBS = "reprioritize_any_jobs"
WATCH_ALL_EVENTS = "watch_all_events"
EXECUTE_JOBS = "execute_jobs"
CORDON = "cordon"

# Queue-level verbs (queue permission model).
QUEUE_VERBS = ("submit", "cancel", "reprioritize", "watch")


class AnonymousAuth:
    """auth/anonymous: everyone is the anonymous principal."""

    def authenticate(self, metadata: dict) -> Principal | None:
        return ANONYMOUS


class BasicAuth:
    """auth/basic: username/password from an `authorization: Basic ...`
    header; users = {name: {"password": ..., "groups": [...]}}."""

    def __init__(self, users: dict):
        self.users = users

    def authenticate(self, metadata: dict) -> Principal | None:
        header = metadata.get("authorization", "")
        if not header.startswith("Basic "):
            return None
        try:
            decoded = base64.b64decode(header[6:]).decode()
            name, _, password = decoded.partition(":")
        except Exception:
            raise AuthError("malformed basic credentials")
        user = self.users.get(name)
        if user is None or user.get("password") != password:
            raise AuthError(f"invalid credentials for {name!r}")
        return Principal(
            name=name, groups=frozenset(user.get("groups", ())), auth_method="basic"
        )


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def make_token(secret: str, sub: str, groups=(), exp: float | None = None,
               iss: str = "armada-tpu") -> str:
    """Mint an HS256 JWT (test/ops helper; the CLI login flow uses it)."""
    header = {"alg": "HS256", "typ": "JWT"}
    claims = {"sub": sub, "groups": list(groups), "iss": iss}
    if exp is not None:
        claims["exp"] = exp
    signing = (
        _b64url(json.dumps(header).encode())
        + "."
        + _b64url(json.dumps(claims).encode())
    )
    sig = hmac.new(secret.encode(), signing.encode(), hashlib.sha256).digest()
    return signing + "." + _b64url(sig)


class TokenAuth:
    """auth/oidc-shaped: `authorization: Bearer <jwt>`; HS256-verified,
    claims sub/groups/exp/iss extracted like the reference's OIDC claim
    mapping (oidc.go)."""

    def __init__(self, secret: str, issuer: str = "armada-tpu"):
        self.secret = secret
        self.issuer = issuer

    def authenticate(self, metadata: dict) -> Principal | None:
        header = metadata.get("authorization", "")
        if not header.startswith("Bearer "):
            return None
        token = header[7:]
        parts = token.split(".")
        if len(parts) != 3:
            raise AuthError("malformed token")
        signing = parts[0] + "." + parts[1]
        want = hmac.new(
            self.secret.encode(), signing.encode(), hashlib.sha256
        ).digest()
        try:
            got = _unb64url(parts[2])
        except Exception:
            raise AuthError("malformed token signature")
        if not hmac.compare_digest(want, got):
            raise AuthError("bad token signature")
        try:
            claims = json.loads(_unb64url(parts[1]))
        except Exception:
            raise AuthError("malformed token claims")
        if claims.get("iss") != self.issuer:
            raise AuthError("wrong token issuer")
        exp = claims.get("exp")
        if exp is not None and time.time() > float(exp):
            raise AuthError("token expired")
        return Principal(
            name=str(claims.get("sub", "")),
            groups=frozenset(claims.get("groups", ())),
            auth_method="token",
        )


class JwksTokenAuth:
    """auth/oidc.go-shaped: `authorization: Bearer <jwt>` verified RS256
    against a JWKS document (the reference validates OIDC access tokens
    against the IdP's JWKS; this environment is zero-egress, so the JWKS
    is supplied as a dict or local file — rotate by rewriting the file,
    it is re-read when its mtime changes). Claim mapping (sub, groups,
    exp, iss) matches TokenAuth/oidc.go."""

    def __init__(
        self,
        jwks: dict | None = None,
        jwks_file: str | None = None,
        issuer: str = "armada-tpu",
        audience: str | None = None,
    ):
        if jwks is None and jwks_file is None:
            raise ValueError("JwksTokenAuth needs jwks= or jwks_file=")
        self._jwks = jwks
        self._jwks_file = jwks_file
        self._mtime = None
        self.issuer = issuer
        self.audience = audience
        self._keys: dict[str, object] = {}
        self._load()

    def _load(self):
        import os

        doc = self._jwks
        if self._jwks_file is not None:
            mtime = os.stat(self._jwks_file).st_mtime
            if mtime == self._mtime:
                return
            self._mtime = mtime
            with open(self._jwks_file) as f:
                doc = json.load(f)
        from cryptography.hazmat.primitives.asymmetric.rsa import (
            RSAPublicNumbers,
        )

        keys = {}
        for k in doc.get("keys", ()):
            if k.get("kty") != "RSA" or k.get("alg", "RS256") != "RS256":
                continue
            n = int.from_bytes(_unb64url(k["n"]), "big")
            e = int.from_bytes(_unb64url(k["e"]), "big")
            keys[k.get("kid", "")] = RSAPublicNumbers(e, n).public_key()
        self._keys = keys

    def authenticate(self, metadata: dict) -> Principal | None:
        header = metadata.get("authorization", "")
        if not header.startswith("Bearer "):
            return None
        token = header[7:]
        parts = token.split(".")
        if len(parts) != 3:
            raise AuthError("malformed token")
        try:
            hdr = json.loads(_unb64url(parts[0]))
        except Exception:
            raise AuthError("malformed token header")
        if hdr.get("alg") != "RS256":
            # Not ours — let the next authenticator (e.g. HS256) decide.
            return None
        if self._jwks_file is not None:
            # Hot-reload on rotation; a mid-rotation unreadable/partial
            # file must not take the API down — keep serving the
            # previously loaded keys until the new document is readable.
            try:
                self._load()
            except Exception:
                pass
        key = self._keys.get(hdr.get("kid", ""))
        if key is None and len(self._keys) == 1:
            key = next(iter(self._keys.values()))
        if key is None:
            raise AuthError("no JWKS key for token kid")
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding

        signing = (parts[0] + "." + parts[1]).encode()
        try:
            key.verify(
                _unb64url(parts[2]), signing, padding.PKCS1v15(), hashes.SHA256()
            )
        except InvalidSignature:
            raise AuthError("bad token signature")
        except Exception as e:
            raise AuthError(f"malformed token signature: {e}")
        try:
            claims = json.loads(_unb64url(parts[1]))
        except Exception:
            raise AuthError("malformed token claims")
        if claims.get("iss") != self.issuer:
            raise AuthError("wrong token issuer")
        if self.audience is not None:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise AuthError("wrong token audience")
        exp = claims.get("exp")
        if exp is not None and time.time() > float(exp):
            raise AuthError("token expired")
        return Principal(
            name=str(claims.get("sub", "")),
            groups=frozenset(claims.get("groups", ())),
            auth_method="jwks",
        )


def make_rs256_token(private_key, sub: str, groups=(), exp=None,
                     iss: str = "armada-tpu", kid: str = "k1", aud=None) -> str:
    """Mint an RS256 JWT (test/ops helper; private_key is a cryptography
    RSAPrivateKey)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    header = {"alg": "RS256", "typ": "JWT", "kid": kid}
    claims = {"sub": sub, "groups": list(groups), "iss": iss}
    if exp is not None:
        claims["exp"] = exp
    if aud is not None:
        claims["aud"] = aud
    signing = (
        _b64url(json.dumps(header).encode())
        + "."
        + _b64url(json.dumps(claims).encode())
    )
    sig = private_key.sign(signing.encode(), padding.PKCS1v15(), hashes.SHA256())
    return signing + "." + _b64url(sig)


def jwks_of(public_key, kid: str = "k1") -> dict:
    """The JWKS document for an RSA public key (test/ops helper)."""
    nums = public_key.public_numbers()

    def be(i: int) -> str:
        return _b64url(i.to_bytes((i.bit_length() + 7) // 8, "big"))

    return {
        "keys": [
            {"kty": "RSA", "alg": "RS256", "use": "sig", "kid": kid,
             "n": be(nums.n), "e": be(nums.e)}
        ]
    }


class MultiAuth:
    """auth/multi.go: try each authenticator in order; the first that
    recognises the credential shape decides; none matching -> error."""

    def __init__(self, authenticators: list):
        self.authenticators = list(authenticators)

    def authenticate(self, metadata: dict) -> Principal:
        for auth in self.authenticators:
            principal = auth.authenticate(metadata or {})
            if principal is not None:
                return principal
        raise AuthError("no credentials accepted by any authenticator")


@dataclass(frozen=True)
class QueuePermission:
    """One queue permission grant (pkg/client/queue Permissions)."""

    subjects: tuple = ()  # user or group names
    verbs: tuple = QUEUE_VERBS


@dataclass
class Authorizer:
    """permissions.go: group -> global permission map, plus per-queue
    grants resolved through the queue registry."""

    # {permission: [group-or-user, ...]}
    permission_groups: dict = field(default_factory=dict)
    # Groups holding every permission (the reference's admin mapping).
    admin_groups: tuple = ("admin",)

    def has_global(self, principal: Principal, permission: str) -> bool:
        if principal.in_any(self.admin_groups):
            return True
        return principal.in_any(self.permission_groups.get(permission, ()))

    def authorize_global(self, principal: Principal, permission: str):
        if not self.has_global(principal, permission):
            raise PermissionDenied(
                f"{principal.name} lacks permission {permission}"
            )

    def authorize_queue(
        self, principal: Principal, verb: str, queue, global_permission: str
    ):
        """Queue-scoped action: allowed by the global permission, queue
        ownership, or a queue permission grant naming the principal."""
        if self.has_global(principal, global_permission):
            return
        owners = getattr(queue, "owners", ()) if queue is not None else ()
        if principal.in_any(owners):
            return
        for grant in getattr(queue, "permissions", ()) if queue is not None else ():
            if verb in grant.verbs and principal.in_any(grant.subjects):
                return
        raise PermissionDenied(
            f"{principal.name} may not {verb} on queue "
            f"{getattr(getattr(queue, 'spec', None), 'name', '?')}"
        )
