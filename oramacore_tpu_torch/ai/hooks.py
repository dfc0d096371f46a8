"""Sandboxed hook runtime — the orama-js-pool equivalent.

Reference: `orama-js-pool` (Deno/V8 pool with evaluation/execution
timeouts and HTTP domain allow/deny, lib.rs:75-139), hook types in
`oramacore_lib::hook_storage` (BeforeRetrieval, BeforeAnswer,
BeforeSearch, TransformDocumentBeforeSave, TransformDocumentAfterSearch —
run_hooks.rs:4, search.rs:158-172, write/mod.rs:817-842).

This environment ships no JS engine, so hooks execute in SANDBOXED
SUBPROCESSES. The sandbox is real, not just rlimits (ADVICE r1):

- a seccomp-BPF deny filter (installed in-process via prctl before the
  user code runs) blocks socket/connect/bind (all direct network),
  open/openat/unlink/rename/mkdir (all filesystem access — safe stdlib
  modules are pre-imported before the filter engages), execve/fork,
  ptrace, mount and chroot; blocked syscalls return EPERM
- the subprocess runs with a SCRUBBED environment (no host env secrets
  leak into tenant code) and a throwaway scratch cwd
- CPU/address-space/file-size rlimits + a wall-clock timeout
- HTTP egress exists ONLY through a brokered `fetch(url, ...)` function:
  requests travel over a dedicated pipe to the parent, which enforces
  the configured domain allow/deny lists (orama-js-pool lib.rs:75-139
  semantics) and performs the request itself

The default hook language is Python (a function named after the hook
type, or `hook(input)`); a `node` executor is used automatically for
`.js`-style hooks when a JS runtime is installed. Hook stdout/stderr
stream to per-collection log subscribers (the `GET {c}/logs` SSE
endpoint — reference sides/logs.rs:18-80).

The port's copy of `oramacore_tpu/ai/hooks.py`, with the same names and
behaviour. The subprocess prelude imports only the standard library,
never torch nor this package, so a hook costs an interpreter's start and
no more.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

HOOK_TYPES = (
    "BeforeRetrieval",
    "BeforeAnswer",
    "BeforeSearch",
    "TransformDocumentBeforeSave",
    "TransformDocumentAfterSearch",
)

_PY_HARNESS = r"""
import json, resource, sys

# stdlib that hooks may use: imported BEFORE the seccomp filter blocks
# the filesystem (imports need openat). socket/subprocess import fine
# but their syscalls are denied — attempts fail at the operation.
import math, re, string, datetime, random, itertools, functools, collections  # noqa
import os, socket, subprocess  # noqa

payload = json.loads(sys.stdin.read())
code = payload["code"]
hook_name = payload["hook"]
hook_input = payload["input"]
req_fd = payload.get("fetch_req_fd")
resp_fd = payload.get("fetch_resp_fd")

resource.setrlimit(resource.RLIMIT_CPU, (5, 5))
for lim, val in ((resource.RLIMIT_AS, 512 << 20),
                 (resource.RLIMIT_FSIZE, 1 << 20),
                 (resource.RLIMIT_NPROC, 16)):
    try:
        resource.setrlimit(lim, (val, val))
    except (ValueError, OSError):
        pass


def _install_seccomp():
    import ctypes, struct

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(38, 1, 0, 0, 0) != 0:  # PR_SET_NO_NEW_PRIVS
        return False
    AUDIT_ARCH_X86_64 = 0xC000003E
    RET_ALLOW = 0x7FFF0000
    RET_EPERM = 0x00050000 | 1  # SECCOMP_RET_ERRNO | EPERM
    DENY = [
        2, 257, 437, 85,            # open, openat, openat2, creat
        87, 263, 82, 264, 316,      # unlink(at), rename(at)(2)
        83, 258, 84, 76, 90, 92,    # mkdir(at), rmdir, truncate, chmod, chown
        41, 42, 43, 44, 45, 46, 47, 49, 50, 53, 288,  # sockets
        59, 322, 57, 58,            # execve(at), fork, vfork
        101, 165, 166, 161,         # ptrace, mount, umount2, chroot
        105, 106,                   # setuid, setgid
    ]
    insns = []
    insns.append(struct.pack("<HBBI", 0x20, 0, 0, 4))          # ld arch
    insns.append(struct.pack("<HBBI", 0x15, 1, 0, AUDIT_ARCH_X86_64))
    insns.append(struct.pack("<HBBI", 0x06, 0, 0, 0))           # ret KILL
    insns.append(struct.pack("<HBBI", 0x20, 0, 0, 0))           # ld nr
    n = len(DENY)
    for k, nr in enumerate(DENY):
        insns.append(struct.pack("<HBBI", 0x15, n - k, 0, nr))  # jeq -> EPERM
    insns.append(struct.pack("<HBBI", 0x06, 0, 0, RET_ALLOW))
    insns.append(struct.pack("<HBBI", 0x06, 0, 0, RET_EPERM))
    buf = ctypes.create_string_buffer(b"".join(insns))

    class sock_fprog(ctypes.Structure):
        _fields_ = [("len", ctypes.c_ushort), ("filter", ctypes.c_void_p)]

    prog = sock_fprog(len(insns), ctypes.cast(buf, ctypes.c_void_p))
    return libc.prctl(22, 2, ctypes.byref(prog), 0, 0) == 0  # PR_SET_SECCOMP


_sandboxed = _install_seccomp()
if not _sandboxed:
    print("seccomp filter unavailable; rlimits-only sandbox", file=sys.stderr)


def fetch(url, method="GET", body=None, headers=None, timeout=5.0):
    # Brokered HTTP: the parent enforces domain allow/deny and performs
    # the request. Direct sockets are blocked by seccomp.
    if req_fd is None or resp_fd is None:
        raise RuntimeError("fetch is not available for this hook")
    req = json.dumps({"url": url, "method": method, "body": body,
                      "headers": headers, "timeout": timeout}) + "\n"
    import os as _os
    _os.write(req_fd, req.encode())
    chunks = b""
    while not chunks.endswith(b"\n"):
        part = _os.read(resp_fd, 65536)
        if not part:
            raise RuntimeError("fetch broker closed")
        chunks += part
    resp = json.loads(chunks)
    if "error" in resp:
        raise RuntimeError(resp["error"])
    return resp


scope = {"fetch": fetch}
exec(compile(code, "<hook>", "exec"), scope)  # user hook code
fn = scope.get(hook_name) or scope.get("hook") or scope.get(
    hook_name[0].lower() + hook_name[1:]
)
if fn is None:
    print(json.dumps({"error": f"hook function {hook_name!r} not defined"}))
    sys.exit(0)
try:
    out = fn(*hook_input) if isinstance(hook_input, list) else fn(hook_input)
    print(json.dumps({"ok": out}))
except Exception as e:  # noqa: BLE001
    print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
"""

_JS_HARNESS = r"""
const chunks = [];
process.stdin.on('data', (c) => chunks.push(c));
process.stdin.on('end', () => {
  const payload = JSON.parse(Buffer.concat(chunks).toString());
  let fn;
  try {
    const module = { exports: {} };
    const wrapper = new Function('module', 'exports', payload.code + '\n;return typeof ' + payload.hook + ' !== "undefined" ? ' + payload.hook + ' : (module.exports.default || module.exports);');
    fn = wrapper(module, module.exports);
  } catch (e) { console.log(JSON.stringify({error: String(e)})); return; }
  try {
    const input = payload.input;
    const out = Array.isArray(input) ? fn(...input) : fn(input);
    Promise.resolve(out).then((v) => console.log(JSON.stringify({ok: v === undefined ? null : v})));
  } catch (e) { console.log(JSON.stringify({error: String(e)})); }
});
"""


def _looks_like_js(code: str) -> bool:
    markers = ("function ", "=>", "const ", "let ", "export default", "var ")
    py_markers = ("def ", "import ", "lambda ")
    has_js = any(m in code for m in markers)
    has_py = any(m in code for m in py_markers)
    return has_js and not has_py


class HookExecutionError(Exception):
    pass


def _host_of(url: str) -> str:
    from urllib.parse import urlparse

    return (urlparse(url).hostname or "").lower()


def _domain_matches(host: str, domain: str) -> bool:
    d = domain.lower().lstrip(".")
    return host == d or host.endswith("." + d)


def _resolves_to_private(host: str) -> bool:
    """True if host is, or resolves to, a non-public address
    (loopback, link-local incl. 169.254.169.254 metadata, RFC1918,
    unique-local v6). DNS is resolved so rebound names don't slip by."""
    import ipaddress
    import socket

    def private_ip(s: str) -> bool:
        try:
            ip = ipaddress.ip_address(s)
        except ValueError:
            return False
        return (
            ip.is_private or ip.is_loopback or ip.is_link_local
            or ip.is_reserved or ip.is_unspecified
        )

    if host in ("localhost",) or private_ip(host):
        return True
    try:
        infos = socket.getaddrinfo(host, None)
    except OSError:
        return True  # unresolvable: refuse rather than probe
    return any(private_ip(info[4][0]) for info in infos)


def _put_log(q: asyncio.Queue, entry: Dict[str, Any]) -> None:
    try:
        q.put_nowait(entry)
    except asyncio.QueueFull:
        pass  # a subscriber that does not read loses entries


class HooksRuntime:
    """Executes hook code in sandboxed subprocesses; streams logs."""

    def __init__(
        self,
        execution_timeout_s: float = 5.0,
        allowed_domains: Optional[Sequence[str]] = None,
        deny_domains: Optional[Sequence[str]] = None,
        allow_js: bool = False,
    ):
        self.execution_timeout_s = execution_timeout_s
        self.allowed_domains = list(allowed_domains or [])
        self.deny_domains = list(deny_domains or [])
        # JS hooks lack the seccomp + brokered-fetch sandbox the Python
        # harness gets (node has no injectable syscall filter here; the
        # reference isolates JS in orama-js-pool/V8). Default-deny so
        # operators opt into the weaker isolation deliberately
        # (config hooks.allow_js).
        self.allow_js = allow_js
        self._node = shutil.which("node")
        self._log_subs: Dict[str, List[tuple]] = {}  # (queue, its loop)
        self._log_lock = threading.Lock()

    # -- HTTP broker (domain allow/deny, js-pool lib.rs:75-139) -----------

    def domain_allowed(self, url: str) -> bool:
        host = _host_of(url)
        if not host:
            return False
        if any(_domain_matches(host, d) for d in self.deny_domains):
            return False
        if self.allowed_domains:
            return any(_domain_matches(host, d) for d in self.allowed_domains)
        # no allowlist: public internet only. The broker runs in the
        # PARENT process (full network, inside the trust boundary), so
        # tenant hook code must not be able to use it as an SSRF proxy
        # to loopback/link-local/private targets (cloud metadata, the
        # server's own localhost surfaces). Explicit allowlisting of a
        # private domain is the opt-in.
        return not _resolves_to_private(host)

    def _do_fetch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        url = str(req.get("url", ""))
        if not url.startswith(("http://", "https://")):
            return {"error": f"unsupported url scheme: {url[:40]}"}
        if not self.domain_allowed(url):
            return {"error": f"domain not allowed by hook policy: {_host_of(url)}"}
        import urllib.request

        try:
            r = urllib.request.Request(
                url,
                data=(req.get("body") or "").encode() if req.get("body") else None,
                headers=dict(req.get("headers") or {}),
                method=str(req.get("method", "GET")),
            )
            with urllib.request.urlopen(
                r, timeout=min(float(req.get("timeout", 5.0)), 10.0)
            ) as resp:
                return {
                    "status": resp.status,
                    "body": resp.read(1 << 20).decode(errors="replace"),
                }
        except Exception as e:  # noqa: BLE001
            return {"error": f"{type(e).__name__}: {e}"}

    def _broker_loop(self, req_r: int, resp_w: int, collection_id: str,
                     hook_name: str):
        """Service fetch requests from the sandboxed child until EOF."""
        buf = b""
        try:
            while True:
                chunk = os.read(req_r, 65536)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    try:
                        req = json.loads(line)
                        out = self._do_fetch(req)
                    except Exception as e:  # noqa: BLE001
                        out = {"error": str(e)}
                    if "error" in out:
                        self._emit_log(
                            collection_id,
                            {"level": "warn", "hook": hook_name,
                             "message": f"fetch: {out['error']}"},
                        )
                    os.write(resp_w, json.dumps(out).encode() + b"\n")
        except OSError:
            return

    # -- log streaming ----------------------------------------------------

    def subscribe_logs(self, collection_id: str) -> asyncio.Queue:
        """A queue of the collection's log entries, on the caller's event
        loop (hooks run on executor threads too: an entry reaches the
        queue through its loop)."""
        q: asyncio.Queue = asyncio.Queue(maxsize=1000)
        loop = asyncio.get_running_loop()
        with self._log_lock:
            self._log_subs.setdefault(collection_id, []).append((q, loop))
        return q

    def unsubscribe_logs(self, collection_id: str, q: asyncio.Queue) -> None:
        with self._log_lock:
            subs = self._log_subs.get(collection_id, [])
            subs[:] = [s for s in subs if s[0] is not q]

    def _emit_log(self, collection_id: str, entry: Dict[str, Any]) -> None:
        with self._log_lock:
            subs = list(self._log_subs.get(collection_id, []))
        for q, loop in subs:
            try:
                loop.call_soon_threadsafe(_put_log, q, entry)
            except RuntimeError:
                pass  # the subscriber's loop has closed

    # -- execution ----------------------------------------------------------

    def exec_hook(
        self,
        collection_id: str,
        hook_name: str,
        code: str,
        hook_input: Any,
    ) -> Optional[Any]:
        """Run hook code; returns the hook's output or None on error/skip
        (reference: typed exec returning Option)."""
        is_js = _looks_like_js(code)
        if is_js and not self.allow_js:
            self._emit_log(
                collection_id,
                {"level": "error", "hook": hook_name,
                 "message": "JS hooks are disabled (hooks.allow_js=false: "
                            "the node executor lacks the seccomp/brokered-"
                            "fetch sandbox of the Python harness); skipped"},
            )
            return None
        if is_js and not self._node:
            self._emit_log(
                collection_id,
                {"level": "error", "hook": hook_name,
                 "message": "JS hook requires a node runtime (not installed); skipped"},
            )
            return None

        # brokered-fetch pipes: the ONLY egress from the sandbox
        req_r, req_w = os.pipe()
        resp_r, resp_w = os.pipe()
        payload_dict = {
            "code": code, "hook": hook_name, "input": hook_input,
            "fetch_req_fd": req_w, "fetch_resp_fd": resp_r,
        }
        if is_js:
            argv = [self._node, "-e", _JS_HARNESS]
            payload_dict.pop("fetch_req_fd")
            payload_dict.pop("fetch_resp_fd")
        else:
            argv = [sys.executable, "-I", "-c", _PY_HARNESS]
        payload = json.dumps(payload_dict)

        t0 = time.perf_counter()
        scratch = tempfile.mkdtemp(prefix="hook-scratch-")
        # scrubbed environment: tenant code must not see host env secrets
        env = {"PATH": "/usr/bin:/bin", "HOME": scratch, "LANG": "C.UTF-8"}
        broker = None
        try:
            proc = subprocess.Popen(
                argv,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                pass_fds=() if is_js else (req_w, resp_r),
                env=env,
                cwd=scratch,
            )
            os.close(req_w)
            os.close(resp_r)
            broker = threading.Thread(
                target=self._broker_loop,
                args=(req_r, resp_w, collection_id, hook_name),
                daemon=True,
            )
            broker.start()
            try:
                stdout_b, stderr_b = proc.communicate(
                    payload.encode(), timeout=self.execution_timeout_s
                )
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                self._emit_log(
                    collection_id,
                    {"level": "error", "hook": hook_name,
                     "message": "hook timed out"},
                )
                return None
        finally:
            try:
                os.close(resp_w)
            except OSError:
                pass
            try:
                os.close(req_r)
            except OSError:
                pass
            shutil.rmtree(scratch, ignore_errors=True)

        class proc_result:  # keep the downstream parsing shape
            stdout = stdout_b
            stderr = stderr_b
            returncode = proc.returncode

        proc = proc_result
        took = (time.perf_counter() - t0) * 1000
        stderr = proc.stderr.decode(errors="replace").strip()
        if stderr:
            self._emit_log(
                collection_id,
                {"level": "stderr", "hook": hook_name, "message": stderr},
            )
        out_lines = proc.stdout.decode(errors="replace").strip().splitlines()
        # hook prints before the result line stream as stdout logs
        for line in out_lines[:-1]:
            self._emit_log(
                collection_id,
                {"level": "stdout", "hook": hook_name, "message": line},
            )
        if not out_lines:
            self._emit_log(
                collection_id,
                {"level": "error", "hook": hook_name,
                 "message": f"hook produced no output (exit {proc.returncode})"},
            )
            return None
        try:
            result = json.loads(out_lines[-1])
        except json.JSONDecodeError:
            self._emit_log(
                collection_id,
                {"level": "error", "hook": hook_name,
                 "message": f"hook output not JSON: {out_lines[-1][:200]}"},
            )
            return None
        self._emit_log(
            collection_id,
            {"level": "info", "hook": hook_name,
             "message": f"executed in {took:.1f}ms"},
        )
        if "error" in result:
            self._emit_log(
                collection_id,
                {"level": "error", "hook": hook_name, "message": result["error"]},
            )
            return None
        return result.get("ok")
