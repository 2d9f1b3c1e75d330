"""Opt-in security layer for the RemoteVerifier server.

A copy of `nanowakeword_tpu/interpreter/server_security.py` (standard
library only; the port imports nothing of the JAX package), with the same
public API (`SecurityConfig`, `SecurityManager`, `build_security`, token wire
helpers): salted-SHA256 API keys with constant-time verification,
HMAC-signed expiring tokens, per-IP sliding-window rate limiting with timed
bans, CIDR allowlists, TLS/mTLS context building, and a connection cap.
Everything defaults to disabled so an open server pays zero overhead
(`build_security` returns None in that case).

Wire compatibility: the token-exchange message is tag 0xF0 + API-key bytes;
responses are JSON ``{"token": ...}`` / ``{"error": ...}``, the same as the
JAX package's server, so a token issued by one verifies in the other (given
the same secret) and mixed deployments interoperate.
"""

from __future__ import annotations

import hashlib
import hmac
import ipaddress
import json
import logging
import secrets
import ssl
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_TAG_TOKEN_REQUEST = 0xF0


# -- key and token primitives --------------------------------------------------

class KeyStore:
    """Salted-SHA256 API-key storage; plaintext discarded after hashing."""

    def __init__(self, keys: List[str]):
        self._hashes = [self.hash_key(k) for k in keys]

    @staticmethod
    def hash_key(key: str) -> str:
        salt = secrets.token_hex(16)
        digest = hashlib.sha256(f"{salt}{key}".encode()).hexdigest()
        return f"{salt}${digest}"

    @staticmethod
    def check(key: str, stored: str) -> bool:
        salt, _, digest = stored.partition("$")
        if not digest:
            return False
        candidate = hashlib.sha256(f"{salt}{key}".encode()).hexdigest()
        return hmac.compare_digest(candidate, digest)

    def verify(self, key: str) -> bool:
        return any(self.check(key, h) for h in self._hashes)

    def __len__(self):
        return len(self._hashes)


class TokenSigner:
    """Expiring HMAC-SHA256 tokens: ``expiry_ts.signature_hex``."""

    def __init__(self, secret: Optional[str] = None):
        self.secret = secret or secrets.token_hex(32)

    def issue(self, ttl: int) -> str:
        expiry = int(time.time()) + ttl
        sig = hmac.new(self.secret.encode(), str(expiry).encode(),
                       hashlib.sha256).hexdigest()
        return f"{expiry}.{sig}"

    def verify(self, token: str) -> bool:
        expiry_str, _, sig = str(token).partition(".")
        if not sig:
            return False
        try:
            expiry = int(expiry_str)
        except ValueError:
            return False
        if time.time() > expiry:
            return False
        expected = hmac.new(self.secret.encode(), expiry_str.encode(),
                            hashlib.sha256).hexdigest()
        return hmac.compare_digest(expected, sig)


# -- config ---------------------------------------------------------------------

@dataclass
class SecurityConfig:
    """All optional server security settings; each feature off by default."""

    api_keys: List[str] = field(default_factory=list)
    enable_tokens: bool = False
    token_ttl: int = 3600
    token_secret: Optional[str] = None
    rate_limit: int = 0
    rate_window: int = 60
    ip_allowlist: List[str] = field(default_factory=list)
    ssl_certfile: Optional[str] = None
    ssl_keyfile: Optional[str] = None
    ssl_ca_certs: Optional[str] = None
    max_connections: int = 0
    ban_duration: int = 300

    @property
    def auth_enabled(self) -> bool:
        return bool(self.api_keys)

    @property
    def tls_enabled(self) -> bool:
        return bool(self.ssl_certfile and self.ssl_keyfile)

    @property
    def rate_limiting_enabled(self) -> bool:
        return self.rate_limit > 0

    @property
    def allowlist_enabled(self) -> bool:
        return bool(self.ip_allowlist)

    def summary(self) -> str:
        feats = []
        if self.auth_enabled:
            feats.append(f"API-key auth ({len(self.api_keys)} key(s))")
        if self.enable_tokens:
            feats.append(f"token auth (TTL={self.token_ttl}s)")
        if self.tls_enabled:
            feats.append("WSS/TLS")
        if self.rate_limiting_enabled:
            feats.append(f"rate-limit ({self.rate_limit} req/"
                         f"{self.rate_window}s)")
        if self.allowlist_enabled:
            feats.append(f"IP allowlist ({len(self.ip_allowlist)} entries)")
        if self.max_connections > 0:
            feats.append(f"max-connections={self.max_connections}")
        return ", ".join(feats) if feats else "none (open server)"


# -- runtime manager ---------------------------------------------------------------

class SecurityManager:
    """Runtime engine: handshake checks, rate limiting, bans, TLS context."""

    def __init__(self, config: SecurityConfig):
        self.config = config
        self._keys = KeyStore(config.api_keys)
        self._tokens = TokenSigner(config.token_secret)
        if config.enable_tokens and not config.token_secret:
            logger.info("security: Token secret auto-generated; set "
                        "token_secret explicitly for persistent deployments.")

        self._request_log: Dict[str, deque] = defaultdict(deque)
        self._bans: Dict[str, float] = {}
        self._active_connections = 0

        self._networks = []
        for entry in config.ip_allowlist:
            try:
                self._networks.append(ipaddress.ip_network(entry,
                                                           strict=False))
            except ValueError:
                logger.warning(f"security: Invalid allowlist entry ignored: "
                               f"'{entry}'")

        self._ssl_context: Optional[ssl.SSLContext] = None
        if config.tls_enabled:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile=config.ssl_certfile,
                                keyfile=config.ssl_keyfile)
            if config.ssl_ca_certs:
                ctx.load_verify_locations(cafile=config.ssl_ca_certs)
                ctx.verify_mode = ssl.CERT_REQUIRED
                logger.info("security: Mutual TLS (mTLS) enabled.")
            self._ssl_context = ctx

        logger.info(f"security: Active features: {config.summary()}")

    @property
    def ssl_context(self) -> Optional[ssl.SSLContext]:
        return self._ssl_context

    # connection cap
    def connection_allowed(self) -> bool:
        if self.config.max_connections <= 0:
            return True
        return self._active_connections < self.config.max_connections

    def on_connect(self) -> None:
        self._active_connections += 1

    def on_disconnect(self) -> None:
        self._active_connections = max(0, self._active_connections - 1)

    # allowlist
    def ip_allowed(self, ip: str) -> bool:
        if not self.config.allowlist_enabled:
            return True
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            logger.warning(f"security: Could not parse client IP: '{ip}'")
            return False
        return any(addr in net for net in self._networks)

    # rate limiting
    def is_banned(self, ip: str) -> bool:
        expiry = self._bans.get(ip)
        if expiry is None:
            return False
        if time.time() < expiry:
            return True
        del self._bans[ip]
        return False

    def record_request(self, ip: str) -> bool:
        """Sliding-window per-IP message budget; returns False when the
        sender is over budget (and bans it if ban_duration > 0)."""
        if not self.config.rate_limiting_enabled:
            return True
        now = time.time()
        window = self._request_log[ip]
        while window and now - window[0] > self.config.rate_window:
            window.popleft()
        if len(window) < self.config.rate_limit:
            window.append(now)
            return True
        if self.config.ban_duration > 0:
            self._bans[ip] = now + self.config.ban_duration
            logger.warning("security: %s over message budget "
                           "(%d/%ds) — banned for %ds", ip,
                           self.config.rate_limit, self.config.rate_window,
                           self.config.ban_duration)
        else:
            logger.warning("security: %s over message budget — "
                           "message dropped", ip)
        return False

    # auth
    def verify_api_key(self, key: str) -> bool:
        if not self.config.auth_enabled:
            return True
        return self._keys.verify(key)

    def issue_token(self) -> str:
        return self._tokens.issue(self.config.token_ttl)

    def verify_token(self, token: str) -> bool:
        if not self.config.enable_tokens:
            return True
        return self._tokens.verify(token)

    def check_handshake(self, websocket) -> Tuple[bool, str]:
        """Connection cap -> allowlist -> ban -> X-Token/X-API-Key auth."""
        if not self.connection_allowed():
            return False, "server at max connections"
        ip = client_ip(websocket)
        if not self.ip_allowed(ip):
            logger.warning(f"security: Rejected non-allowlisted IP: {ip}")
            return False, f"IP {ip} not in allowlist"
        if self.is_banned(ip):
            logger.warning(f"security: Rejected banned IP: {ip}")
            return False, f"IP {ip} is temporarily banned"
        if self.config.auth_enabled:
            headers = request_headers(websocket)
            if self.config.enable_tokens:
                token = headers.get("x-token", "")
                if token and self.verify_token(token):
                    return True, "ok"
            api_key = headers.get("x-api-key", "")
            if not api_key:
                logger.warning(f"security: Missing X-API-Key from {ip}")
                return False, "missing X-API-Key header"
            if not self.verify_api_key(api_key):
                logger.warning(f"security: Invalid API key from {ip}")
                return False, "invalid API key"
        return True, "ok"


# -- token-exchange wire helpers ---------------------------------------------------

def is_token_request(message: bytes) -> bool:
    return len(message) >= 2 and message[0] == _TAG_TOKEN_REQUEST


def decode_token_request(message: bytes) -> str:
    return message[1:].decode("utf-8", errors="replace")


def encode_token_request(api_key: str) -> bytes:
    return bytes([_TAG_TOKEN_REQUEST]) + api_key.encode("utf-8")


def encode_token_response(token: str) -> str:
    return json.dumps({"token": token})


def encode_error_response(reason: str) -> str:
    return json.dumps({"error": reason})


# -- websocket adapters -------------------------------------------------------------

def client_ip(websocket) -> str:
    try:
        addr = websocket.remote_address
        return addr[0] if isinstance(addr, tuple) else str(addr)
    except Exception:  # noqa: BLE001
        return "unknown"


def request_headers(websocket) -> Dict[str, str]:
    """Lowercase-key header dict across websockets library versions."""
    for attr in ("request", None):
        try:
            raw = (websocket.request.headers if attr
                   else websocket.request_headers)
            return {k.lower(): v for k, v in raw.items()}
        except AttributeError:
            continue
    return {}


# -- factory -----------------------------------------------------------------------

def build_security(api_keys: Optional[List[str]] = None,
                   enable_tokens: bool = False,
                   token_ttl: int = 3600,
                   token_secret: Optional[str] = None,
                   rate_limit: int = 0,
                   rate_window: int = 60,
                   ip_allowlist: Optional[List[str]] = None,
                   ssl_certfile: Optional[str] = None,
                   ssl_keyfile: Optional[str] = None,
                   ssl_ca_certs: Optional[str] = None,
                   max_connections: int = 0,
                   ban_duration: int = 300) -> Optional[SecurityManager]:
    """Returns a SecurityManager, or None when every feature is disabled."""
    cfg = SecurityConfig(
        api_keys=api_keys or [], enable_tokens=enable_tokens,
        token_ttl=token_ttl, token_secret=token_secret,
        rate_limit=rate_limit, rate_window=rate_window,
        ip_allowlist=ip_allowlist or [], ssl_certfile=ssl_certfile,
        ssl_keyfile=ssl_keyfile, ssl_ca_certs=ssl_ca_certs,
        max_connections=max_connections, ban_duration=ban_duration)
    if (not cfg.auth_enabled and not cfg.tls_enabled
            and not cfg.rate_limiting_enabled and not cfg.allowlist_enabled
            and cfg.max_connections == 0):
        return None
    return SecurityManager(cfg)
