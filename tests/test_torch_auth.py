"""The port's JWT manager (`oramacore_tpu_torch.auth`) and secrets service
(`oramacore_tpu_torch.utils.secrets`) held to the JAX package's.

RS256 tokens are signed here with `cryptography`; the port verifies them
with its own RSASSA-PKCS1-v1_5 code and must accept and refuse exactly
what JAX's `JwtProvider` (which verifies with `cryptography`) does. The
bodies of `tests/test_jwt_integration.py` run on the port's
`build_orama(device="cpu")`.
"""

from __future__ import annotations

import base64
import http.server
import inspect
import json
import threading
import time
import types

import numpy as np
import pytest
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import padding, rsa

from oramacore_tpu import auth as jax_auth
from oramacore_tpu.utils import secrets as jax_secrets
from oramacore_tpu_torch import auth as port_auth
from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch import read as port_read
from oramacore_tpu_torch import runtime as port_runtime
from oramacore_tpu_torch import types as port_types
from oramacore_tpu_torch import write as port_write
from oramacore_tpu_torch.utils import secrets as port_secrets

from . import test_jwt_integration as jwt_suite


def rebound_suite(module, replacements):
    """The test functions of `module`, each with a copy of the module's
    globals in which `replacements` stand: its helpers are rebound to the
    same copy, so a body and the helpers it calls see the port."""
    g = dict(vars(module))
    g.update(replacements)
    for name, f in list(g.items()):
        if inspect.isfunction(f) and f.__module__ == module.__name__:
            g[name] = types.FunctionType(f.__code__, g, f.__name__,
                                         f.__defaults__, f.__closure__)
    return {n: f for n, f in g.items()
            if n.startswith("test_") and inspect.isfunction(f)}


def cpu_build_orama(config, **kwargs):
    kwargs.setdefault("device", "cpu")
    return port_runtime.build_orama(config, **kwargs)


# ---------------------------------------------------------------------------
# RS256
# ---------------------------------------------------------------------------

def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _jwk(key, kid):
    pub = key.public_key().public_numbers()
    return {"kty": "RSA", "kid": kid, "alg": "RS256", "use": "sig",
            "n": _b64(pub.n.to_bytes((pub.n.bit_length() + 7) // 8, "big")),
            "e": _b64(pub.e.to_bytes(3, "big"))}


def _rs256(key, payload, kid="k1", header=None):
    h = {"alg": "RS256", "typ": "JWT", "kid": kid, **(header or {})}
    signing_input = f"{_b64(json.dumps(h).encode())}." \
                    f"{_b64(json.dumps(payload).encode())}"
    sig = key.sign(signing_input.encode(), padding.PKCS1v15(),
                   hashes.SHA256())
    return f"{signing_input}.{_b64(sig)}"


@pytest.fixture(scope="module")
def keys():
    return {kid: rsa.generate_private_key(public_exponent=65537,
                                          key_size=bits)
            for kid, bits in (("k1", 2048), ("k2", 2048), ("k3", 1024))}


def _tampered(token, part, flip_at=10):
    parts = token.split(".")
    raw = bytearray(base64.urlsafe_b64decode(parts[part] + "=="))
    raw[flip_at % len(raw)] ^= 0x01
    parts[part] = _b64(bytes(raw))
    return ".".join(parts)


def _cases(keys):
    now = time.time()
    good = {"iss": "iss", "aud": "aud", "exp": now + 300, "collectionID": "c"}
    k1 = keys["k1"]
    token = _rs256(k1, good)
    short = token.rsplit(".", 1)[0] + "." + _b64(
        base64.urlsafe_b64decode(token.rsplit(".", 1)[1] + "==")[:-1])
    other = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    return {
        "good": token,
        "good, second key": _rs256(keys["k2"], good, kid="k2"),
        "good, 1024-bit key": _rs256(keys["k3"], good, kid="k3"),
        "good, no kid": _rs256(k1, good, kid=None),
        "good, audience list": _rs256(k1, {**good, "aud": ["x", "aud"]}),
        "tampered payload": _tampered(token, 1),
        "tampered signature": _tampered(token, 2),
        "tampered signature, last byte": _tampered(token, 2, flip_at=-1),
        "wrong kid": _rs256(k1, good, kid="k2"),
        "unknown kid": _rs256(k1, good, kid="nope"),
        "signed by another key": _rs256(other, good),
        "expired": _rs256(k1, {**good, "exp": now - 5}),
        "not yet valid": _rs256(k1, {**good, "nbf": now + 300}),
        "wrong iss": _rs256(k1, {**good, "iss": "other"}),
        "wrong aud": _rs256(k1, {**good, "aud": "other"}),
        "short signature": short,
        "empty signature": token.rsplit(".", 1)[0] + ".",
        "signature of the modulus' length, all ones": token.rsplit(".", 1)[0]
        + "." + _b64(b"\xff" * 256),
        "alg none": token.replace(token.split(".")[0], _b64(json.dumps(
            {"alg": "none", "kid": "k1"}).encode()), 1),
    }


def _verdict(provider, token):
    try:
        return "ok", provider.verify(token)
    except jax_auth.JwtError as e:
        return "refused", str(e)
    except port_auth.JwtError as e:
        return "refused", str(e)


def test_rs256_accepts_and_refuses_as_jax(keys):
    jwks = {"keys": [_jwk(k, kid) for kid, k in keys.items()]}
    jp = jax_auth.JwtProvider(issuer="iss", audience="aud", static_jwks=jwks)
    pp = port_auth.JwtProvider(issuer="iss", audience="aud", static_jwks=jwks)
    seen = set()
    for name, token in _cases(keys).items():
        j, p = _verdict(jp, token), _verdict(pp, token)
        assert p == j, (name, p, j)
        seen.add((name.split(",")[0], j[0]))
    assert {v for n, v in seen if n == "good"} == {"ok"}
    assert {v for n, v in seen if n != "good"} == {"refused"}


def test_rsa_verify_on_random_messages(keys):
    """rsa_pkcs1_sha256_verify against cryptography's verify: seeded
    messages, their signatures, and each with one bit flipped."""
    rng = np.random.default_rng(7)
    key = keys["k1"]
    pub = key.public_key()
    n, e = pub.public_numbers().n, pub.public_numbers().e
    for i in range(24):
        msg = rng.bytes(int(rng.integers(0, 300)))
        sig = key.sign(msg, padding.PKCS1v15(), hashes.SHA256())
        assert port_auth.rsa_pkcs1_sha256_verify(n, e, msg, sig)
        bad = bytearray(sig)
        bad[int(rng.integers(len(bad)))] ^= 1 << int(rng.integers(8))
        try:
            pub.verify(bytes(bad), msg, padding.PKCS1v15(), hashes.SHA256())
            expected = True
        except Exception:  # noqa: BLE001 — InvalidSignature
            expected = False
        assert port_auth.rsa_pkcs1_sha256_verify(n, e, msg, bytes(bad)) \
            == expected
        if msg:
            assert not port_auth.rsa_pkcs1_sha256_verify(n, e, msg[:-1], sig)


def test_jwks_is_fetched_and_cached(keys):
    jwks = {"keys": [_jwk(keys["k1"], "k1")]}
    hits = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            hits.append(self.path)
            body = json.dumps(jwks).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/.well-known/jwks.json"
        p = port_auth.JwtProvider(issuer="iss", audience="aud", jwks_url=url)
        tok = _rs256(keys["k1"], {"iss": "iss", "aud": "aud"})
        assert p.verify(tok)["iss"] == "iss"
        assert p.verify(tok)["aud"] == "aud"
        assert hits == ["/.well-known/jwks.json"]  # cached for 3,600 s
        p._jwks_fetched_at -= 3601
        p.verify(tok)
        assert len(hits) == 2
    finally:
        srv.shutdown()


def test_hs256_tokens_and_claims_match_jax():
    payload = {"iss": "i", "aud": "a", "collectionID": "c", "max_docs": 3,
               "plan": "pro", "exp": time.time() + 60}
    tok = port_auth.make_hs256_token("s", payload)
    assert tok == jax_auth.make_hs256_token("s", payload)
    jm = jax_auth.JwtManager([jax_auth.JwtProvider("i", "a", "s")])
    pm = port_auth.JwtManager([port_auth.JwtProvider("i", "a", "s")])
    assert vars(pm.dashboard_claims(tok)) == vars(jm.dashboard_claims(tok))
    assert vars(pm.customer_claims(tok)) == vars(jm.customer_claims(tok))
    for t in (tok, "a.b", "x" * 80, "eyJ.a.b"):
        assert pm.looks_like_jwt(t) == jm.looks_like_jwt(t)
    with pytest.raises(port_auth.JwtError):
        pm.verify(port_auth.make_hs256_token("wrong", payload))


# ---------------------------------------------------------------------------
# tests/test_jwt_integration.py on the port
# ---------------------------------------------------------------------------

JWT_BODIES = rebound_suite(jwt_suite, {
    "make_hs256_token": port_auth.make_hs256_token,
    "JwtProviderConfig": port_config.JwtProviderConfig,
    "OramacoreConfig": port_config.OramacoreConfig,
    "ReadError": port_read.ReadError,
    "WriteError": port_write.WriteError,
    "SearchParams": port_types.SearchParams,
    "build_orama": cpu_build_orama,
})


def test_every_jwt_body_is_run():
    assert len(JWT_BODIES) == 7


@pytest.mark.parametrize("name", sorted(JWT_BODIES))
def test_jwt_integration_on_port(name, tmp_path):
    JWT_BODIES[name](tmp_path)


def test_build_orama_attaches_the_jwt_manager(tmp_path):
    cfg = port_config.OramacoreConfig()
    cfg.data_dir = str(tmp_path)
    cfg.auth.jwt_providers = [port_config.JwtProviderConfig(
        issuer="i", audience="a", hs256_secret="s")]
    o = cpu_build_orama(cfg, start_consumer=False)
    try:
        for side in (o.write_side, o.read_side):
            assert isinstance(side.jwt_manager, port_auth.JwtManager)
            assert side.jwt_manager.providers[0].hs256_secret == "s"
            assert side.secrets_service is None
    finally:
        o.stop()


# ---------------------------------------------------------------------------
# secrets
# ---------------------------------------------------------------------------

def test_sigv4_headers_equal_jax():
    rng = np.random.default_rng(11)
    for i in range(12):
        args = dict(access_key=f"AKIA{i:04d}", secret_key=rng.bytes(20).hex(),
                    region=["us-east-1", "eu-west-2"][i % 2],
                    service="secretsmanager",
                    session_token=None if i % 3 else f"tok{i}")
        call = ("POST", "secretsmanager.us-east-1.amazonaws.com",
                ["/", "/a b/c"][i % 2],
                ["", "b=2&a=1&a=0&sp%20ace=x y"][i % 2],
                {"content-type": "application/x-amz-json-1.1",
                 "X-Amz-Target": "secretsmanager.GetSecretValue",
                 "x-extra": f"  spaced   value {i} "},
                rng.bytes(int(rng.integers(0, 64))))
        date = f"2024{1 + i % 12:02d}{1 + i:02d}T{i:02d}3000Z"
        j = jax_secrets.SigV4Signer(**args).signed_headers(*call,
                                                           amz_date=date)
        p = port_secrets.SigV4Signer(**args).signed_headers(*call,
                                                            amz_date=date)
        assert p == j
    # the AWS documentation's example key derivation
    s = port_secrets.SigV4Signer("AKIDEXAMPLE",
                                 "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
                                 "us-east-1", "iam")
    assert s.signing_key("20150830").hex() == (
        "c4afb1cc5771d871763a393e44b703571b55cc28424d1a5e86da6ed3c154a4b9")


def test_local_provider_and_service_ttl(tmp_path, monkeypatch):
    path = tmp_path / "secrets.json"
    path.write_text(json.dumps({"coll-a": "s3cret"}))
    monkeypatch.setenv("SECRET_COLL_B", "from-env")
    jp = jax_secrets.make_provider("local", path=str(path))
    pp = port_secrets.make_provider("local", path=str(path))
    for key in ("coll-a", "coll-b", "coll-c"):
        assert pp.get(key) == jp.get(key)
    calls = []

    class Counting(port_secrets.SecretsProvider):
        def get(self, key):
            calls.append(key)
            return f"v{len(calls)}"

    svc = port_secrets.SecretsService(Counting(), ttl_s=300,
                                      key_pattern="tenant/{collection}")
    assert svc.get_for_collection("x") == "v1"
    assert svc.get_for_collection("x") == "v1"
    assert calls == ["tenant/x"]
    svc._cache["tenant/x"] = ("v1", time.time() - 301)
    assert svc.get_for_collection("x") == "v2"


def test_http_provider_against_a_local_server():
    seen = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append((self.path, self.headers.get("Authorization")))
            name = self.path.rsplit("/", 1)[1]
            body = {"json%2Fkey": json.dumps({"SecretString": "from-json"}),
                    "raw": "plain-text",
                    "value": json.dumps({"value": "v"})}.get(name)
            if body is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body.encode())

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/v1/"
        jp = jax_secrets.make_provider("http", url=url, token="tk")
        pp = port_secrets.make_provider("http", url=url, token="tk")
        for key in ("json/key", "raw", "value", "missing"):
            assert pp.get(key) == jp.get(key), key
        assert pp.get("json/key") == "from-json"
        assert pp.get("missing") is None
        assert seen[0] == ("/v1/json%2Fkey", "Bearer tk")
    finally:
        srv.shutdown()


def test_build_orama_attaches_a_secrets_service(tmp_path):
    path = tmp_path / "s.json"
    path.write_text(json.dumps({"c": "xyz"}))
    cfg = port_config.OramacoreConfig()
    cfg.data_dir = str(tmp_path / "data")
    cfg.secrets = port_config.SecretsConfig(provider="local", path=str(path))
    o = cpu_build_orama(cfg, start_consumer=False)
    try:
        svc = o.read_side.secrets_service
        assert svc is o.write_side.secrets_service
        assert svc.get_for_collection("c") == "xyz"
    finally:
        o.stop()
