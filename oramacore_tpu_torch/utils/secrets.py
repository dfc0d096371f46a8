"""Secrets service: provider abstraction with TTL cache.

Reference: `oramacore_lib::secrets::SecretsService` — AWS Secrets Manager
or local provider, TTL cache, per-collection key pattern, values passed
to hooks (write/mod.rs:79,287-296; config.yaml secrets_manager block).

The port's copy of `oramacore_tpu/utils/secrets.py`, with the same names
and behaviour (stdlib only).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class SecretsProvider:
    def get(self, key: str) -> Optional[str]:
        raise NotImplementedError


class LocalSecretsProvider(SecretsProvider):
    """Secrets from a JSON file or environment (SECRET_<NAME>)."""

    def __init__(self, path: Optional[str] = None):
        self._data: Dict[str, str] = {}
        if path and os.path.exists(path):
            with open(path) as fh:
                self._data = json.load(fh)

    def get(self, key: str) -> Optional[str]:
        if key in self._data:
            return self._data[key]
        return os.environ.get(f"SECRET_{key.upper().replace('-', '_')}")


class SigV4Signer:
    """AWS Signature Version 4 request signing, stdlib only (hashlib/hmac).

    The reference reaches AWS Secrets Manager through the AWS SDK
    (`oramacore_lib::secrets`); this image has no boto3, so the wire
    protocol is implemented directly. Algorithm per the AWS SigV4 spec:
    canonical request → string-to-sign → derived signing key → signature.
    """

    def __init__(self, access_key: str, secret_key: str, region: str,
                 service: str, session_token: Optional[str] = None):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.service = service
        self.session_token = session_token

    @staticmethod
    def _hmac(key: bytes, msg: str) -> bytes:
        import hashlib
        import hmac

        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    def signing_key(self, date_stamp: str) -> bytes:
        k = self._hmac(("AWS4" + self.secret_key).encode(), date_stamp)
        k = self._hmac(k, self.region)
        k = self._hmac(k, self.service)
        return self._hmac(k, "aws4_request")

    def signed_headers(
        self,
        method: str,
        host: str,
        path: str,
        query: str,
        headers: Dict[str, str],
        body: bytes,
        amz_date: Optional[str] = None,
    ) -> Dict[str, str]:
        """Return `headers` plus x-amz-date / Authorization (and the
        session token when present). `amz_date` is injectable for the
        spec test vectors; defaults to now (UTC)."""
        import datetime
        import hashlib
        import hmac as _hmac_mod

        if amz_date is None:
            amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
                "%Y%m%dT%H%M%SZ"
            )
        date_stamp = amz_date[:8]
        out = dict(headers)
        out["host"] = host
        out["x-amz-date"] = amz_date
        if self.session_token:
            out["x-amz-security-token"] = self.session_token
        payload_hash = hashlib.sha256(body).hexdigest()

        # canonical headers: lowercase names, sorted, values trimmed
        canon_items = sorted(
            (k.lower(), " ".join(v.split())) for k, v in out.items()
        )
        canonical_headers = "".join(f"{k}:{v}\n" for k, v in canon_items)
        signed_header_names = ";".join(k for k, _ in canon_items)
        # canonical query: URI-encoded pairs sorted by name then value
        import urllib.parse

        pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}="
            f"{urllib.parse.quote(v, safe='-_.~')}"
            for k, v in sorted(pairs)
        )
        canonical_request = "\n".join(
            [
                method,
                path or "/",
                canonical_query,
                canonical_headers,
                signed_header_names,
                payload_hash,
            ]
        )
        scope = f"{date_stamp}/{self.region}/{self.service}/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )
        signature = _hmac_mod.new(
            self.signing_key(date_stamp), string_to_sign.encode(),
            hashlib.sha256,
        ).hexdigest()
        out["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_header_names}, Signature={signature}"
        )
        return out


class AwsSecretsProvider(SecretsProvider):
    """AWS Secrets Manager over raw HTTPS + SigV4 (no SDK dependency).

    Speaks the service's JSON 1.1 protocol: POST / with
    `X-Amz-Target: secretsmanager.GetSecretValue`. Credentials come from
    kwargs or the standard AWS_* environment variables. Zero-egress
    environments will simply get None (same graceful behavior the
    reference's TTL-cached service has on provider errors)."""

    def __init__(self, region: str, *,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 session_token: Optional[str] = None,
                 endpoint: Optional[str] = None,
                 timeout_s: float = 5.0):
        self.region = region
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY")
        self.session_token = (
            session_token or os.environ.get("AWS_SESSION_TOKEN")
        )
        self.endpoint = (
            endpoint or f"https://secretsmanager.{region}.amazonaws.com"
        )
        self.timeout_s = timeout_s
        if not self.access_key or not self.secret_key:
            raise RuntimeError(
                "aws secrets provider needs AWS_ACCESS_KEY_ID/"
                "AWS_SECRET_ACCESS_KEY (env or config)"
            )

    def get(self, key: str) -> Optional[str]:
        import urllib.error
        import urllib.parse
        import urllib.request

        body = json.dumps({"SecretId": key}).encode()
        parsed = urllib.parse.urlparse(self.endpoint)
        # sign and request the SAME path (a mismatch — e.g. signing "/"
        # but requesting "//" — is a silent SignatureDoesNotMatch)
        path = parsed.path or "/"
        url = f"{parsed.scheme}://{parsed.netloc}{path}"
        signer = SigV4Signer(
            self.access_key, self.secret_key, self.region,
            "secretsmanager", self.session_token,
        )
        headers = signer.signed_headers(
            "POST", parsed.netloc, path, "",
            {
                "content-type": "application/x-amz-json-1.1",
                "x-amz-target": "secretsmanager.GetSecretValue",
            },
            body,
        )
        req = urllib.request.Request(
            url, data=body, headers=headers, method="POST"
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                payload = json.loads(r.read().decode(errors="replace"))
        except (urllib.error.URLError, OSError, json.JSONDecodeError):
            return None
        if isinstance(payload, dict):
            return payload.get("SecretString")
        return None


class HttpSecretsProvider(SecretsProvider):
    """Remote secrets over HTTPS (the Secrets-Manager-shaped REST
    contract for environments without boto3): GET <url>/<key> with a
    bearer token; accepts either a raw string body or a JSON object
    with a SecretString field."""

    def __init__(self, url: str, token: Optional[str] = None,
                 timeout_s: float = 5.0):
        self.url = url.rstrip("/")
        self.token = token
        self.timeout_s = timeout_s

    def get(self, key: str) -> Optional[str]:
        import urllib.error
        import urllib.parse
        import urllib.request

        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            f"{self.url}/{urllib.parse.quote(key, safe='')}",
            headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                body = r.read().decode(errors="replace")
        except (urllib.error.URLError, OSError):
            return None
        try:
            data = json.loads(body)
            if isinstance(data, dict):
                return data.get("SecretString") or data.get("value")
            if isinstance(data, str):
                return data
        except json.JSONDecodeError:
            pass
        return body or None


def make_provider(kind: str, **kwargs) -> SecretsProvider:
    """Provider factory for the config layer: local | http | aws."""
    if kind == "local":
        return LocalSecretsProvider(kwargs.get("path"))
    if kind == "http":
        return HttpSecretsProvider(
            kwargs["url"], kwargs.get("token"),
            float(kwargs.get("timeout_s", 5.0)),
        )
    if kind == "aws":
        return AwsSecretsProvider(
            kwargs.get("region", "us-east-1"),
            access_key=kwargs.get("access_key"),
            secret_key=kwargs.get("secret_key"),
            session_token=kwargs.get("session_token"),
            endpoint=kwargs.get("endpoint"),
            timeout_s=float(kwargs.get("timeout_s", 5.0)),
        )
    raise ValueError(f"unknown secrets provider: {kind}")


class SecretsService:
    def __init__(self, provider: SecretsProvider, ttl_s: float = 300.0,
                 key_pattern: str = "{collection}"):
        self.provider = provider
        self.ttl_s = ttl_s
        self.key_pattern = key_pattern
        self._cache: Dict[str, tuple] = {}

    def get_for_collection(self, collection_id: str) -> Optional[str]:
        key = self.key_pattern.format(collection=collection_id)
        now = time.time()
        hit = self._cache.get(key)
        if hit and now - hit[1] < self.ttl_s:
            return hit[0]
        value = self.provider.get(key)
        self._cache[key] = (value, now)
        return value
