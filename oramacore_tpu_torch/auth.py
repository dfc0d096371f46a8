"""JWT auth: HS256/RS256 verification, multi-provider, claims.

Reference: src/auth/jwt_manager.rs:43-123 (JWKS multi-provider),
types.rs:576 DashboardClaims (writes, with doc-count claim_limitations),
types.rs:603 CustomerClaims (reads, extra claims passed to hooks).

No external JWT lib in the image — implemented on stdlib hmac. JWKS keys
can be fetched lazily over HTTP (jwks_url) or configured statically.

The port's copy of `oramacore_tpu/auth.py`, with the same names and
behaviour. The JAX module verifies RS256 with the `cryptography` package,
which the port does without: `rsa_pkcs1_sha256_verify` checks an
RSASSA-PKCS1-v1_5 / SHA-256 signature (RFC 8017 §8.2.2) with Python's
integers.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class JwtError(Exception):
    pass


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def _b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


# DER of DigestInfo{sha256, NULL} up to the 32-byte digest (RFC 8017 §9.2)
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def rsa_pkcs1_sha256_verify(n: int, e: int, message: bytes, sig: bytes) -> bool:
    """RSASSA-PKCS1-v1_5 verification with SHA-256 (RFC 8017 §8.2.2):
    the signature is as long as the modulus, s < n, and s^e mod n equals
    00 01 FF..FF 00 || DigestInfo || SHA-256(message), compared in
    constant time."""
    k = (n.bit_length() + 7) // 8
    t = _SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    if len(sig) != k or k < len(t) + 11:
        return False
    s = int.from_bytes(sig, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    expected = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return hmac.compare_digest(em, expected)


@dataclass
class JwtProvider:
    issuer: str
    audience: str
    hs256_secret: Optional[str] = None
    jwks_url: Optional[str] = None
    static_jwks: Optional[Dict[str, Any]] = None  # {"keys": [...]}
    _jwks_cache: Optional[Dict[str, Any]] = None
    _jwks_fetched_at: float = 0.0

    def _get_jwks(self) -> Dict[str, Any]:
        if self.static_jwks is not None:
            return self.static_jwks
        if self._jwks_cache is not None and time.time() - self._jwks_fetched_at < 3600:
            return self._jwks_cache
        if not self.jwks_url:
            raise JwtError("no JWKS configured")
        import urllib.request

        with urllib.request.urlopen(self.jwks_url, timeout=5) as resp:
            self._jwks_cache = json.loads(resp.read())
            self._jwks_fetched_at = time.time()
        return self._jwks_cache

    def _verify_rs256(self, signing_input: bytes, sig: bytes, kid: Optional[str]) -> bool:
        jwks = self._get_jwks()
        for key in jwks.get("keys", []):
            if kid and key.get("kid") != kid:
                continue
            if key.get("kty") != "RSA":
                continue
            n = int.from_bytes(_b64url_decode(key["n"]), "big")
            e = int.from_bytes(_b64url_decode(key["e"]), "big")
            if rsa_pkcs1_sha256_verify(n, e, signing_input, sig):
                return True
        return False

    def verify(self, token: str) -> Dict[str, Any]:
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
        except ValueError as e:
            raise JwtError("malformed token") from e
        header = json.loads(_b64url_decode(header_b64))
        payload = json.loads(_b64url_decode(payload_b64))
        sig = _b64url_decode(sig_b64)
        signing_input = f"{header_b64}.{payload_b64}".encode()

        alg = header.get("alg")
        if alg == "HS256":
            if not self.hs256_secret:
                raise JwtError("HS256 not configured for provider")
            expected = hmac.new(
                self.hs256_secret.encode(), signing_input, hashlib.sha256
            ).digest()
            if not hmac.compare_digest(expected, sig):
                raise JwtError("invalid signature")
        elif alg == "RS256":
            if not self._verify_rs256(signing_input, sig, header.get("kid")):
                raise JwtError("invalid signature")
        else:
            raise JwtError(f"unsupported alg {alg}")

        now = time.time()
        if "exp" in payload and now > float(payload["exp"]):
            raise JwtError("token expired")
        if "nbf" in payload and now < float(payload["nbf"]):
            raise JwtError("token not yet valid")
        if self.issuer and payload.get("iss") != self.issuer:
            raise JwtError("issuer mismatch")
        if self.audience:
            aud = payload.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise JwtError("audience mismatch")
        return payload


@dataclass
class DashboardClaims:
    """Write-side claims (types.rs:576): scoped collection + doc limits."""

    collection_id: Optional[str] = None
    claim_limitations: Optional[int] = None  # max doc count
    raw: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CustomerClaims:
    """Read-side claims (types.rs:603): extras forwarded to hooks."""

    collection_id: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)
    raw: Dict[str, Any] = field(default_factory=dict)


class JwtManager:
    def __init__(self, providers: List[JwtProvider]):
        self.providers = providers

    @staticmethod
    def looks_like_jwt(token: str) -> bool:
        return token.count(".") == 2 and token.split(".")[0].startswith("eyJ")

    def verify(self, token: str) -> Dict[str, Any]:
        last: Optional[Exception] = None
        for p in self.providers:
            try:
                return p.verify(token)
            except JwtError as e:
                last = e
        raise last or JwtError("no jwt providers configured")

    def dashboard_claims(self, token: str) -> DashboardClaims:
        payload = self.verify(token)
        return DashboardClaims(
            collection_id=payload.get("collectionID") or payload.get("collection_id"),
            claim_limitations=payload.get("claimLimitations", {}).get("maxDocs")
            if isinstance(payload.get("claimLimitations"), dict)
            else payload.get("max_docs"),
            raw=payload,
        )

    def customer_claims(self, token: str) -> CustomerClaims:
        payload = self.verify(token)
        known = {"iss", "aud", "exp", "nbf", "iat", "sub"}
        return CustomerClaims(
            collection_id=payload.get("collectionID") or payload.get("collection_id"),
            extra={k: v for k, v in payload.items() if k not in known},
            raw=payload,
        )


def make_hs256_token(secret: str, payload: Dict[str, Any]) -> str:
    """Helper for tests: mint an HS256 JWT."""
    header = _b64url_encode(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url_encode(json.dumps(payload).encode())
    signing_input = f"{header}.{body}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{body}.{_b64url_encode(sig)}"
