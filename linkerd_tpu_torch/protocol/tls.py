"""TLS configuration for servers and clients: a copy of
``linkerd_tpu/protocol/tls.py``.

Reference parity: finagle/buoyant/src/main/scala/com/twitter/finagle/buoyant/
TlsClientConfig.scala:1-75 (commonName with PathMatcher variable substitution,
trustCerts, disableValidation, clientAuth cert/key) and TlsServerConfig.scala
(certPath/keyPath -> server SSL engine). The reference terminates/originates
TLS via netty-tcnative boringssl (project/Deps.scala:24); here the host data
plane uses CPython's ``ssl`` (OpenSSL) contexts on the asyncio transports.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from linkerd_tpu_torch.config import ConfigError


@dataclass
class TlsClientAuth:
    certPath: str = ""
    keyPath: str = ""


@dataclass
class TlsClientConfig:
    """Per-client TLS origination.

    ``commonName`` may contain ``{var}`` references resolved from a
    per-prefix PathMatcher capture (ref: TlsClientConfig.scala commonName
    w/ PathMatcher.substitute).
    """

    commonName: Optional[str] = None
    trustCerts: List[str] = field(default_factory=list)
    disableValidation: bool = False
    clientAuth: Optional[TlsClientAuth] = None

    def mk_context(self, common_name: Optional[str] = None) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if self.disableValidation:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        else:
            if not (common_name or self.commonName):
                raise ConfigError(
                    "tls client config needs a commonName unless "
                    "disableValidation is set")
            if self.trustCerts:
                for path in self.trustCerts:
                    ctx.load_verify_locations(cafile=path)
            else:
                ctx.load_default_certs()
        if self.clientAuth is not None:
            ctx.load_cert_chain(self.clientAuth.certPath,
                                self.clientAuth.keyPath or None)
        return ctx

    def validate(self, var_names=frozenset()) -> None:
        """Load-time checks: commonName template vars must be capturable by
        the owning prefix, and validation needs a name or an explicit
        opt-out — so misconfig fails startup, not the first request."""
        if not self.disableValidation and self.commonName is None:
            raise ConfigError(
                "tls client config needs a commonName unless "
                "disableValidation is set")
        if self.commonName is not None:
            import re
            refs = set(re.findall(r"\{([^}/]+)\}", self.commonName))
            missing = refs - set(var_names)
            if missing:
                raise ConfigError(
                    f"tls commonName {self.commonName!r} references "
                    f"{sorted(missing)} not captured by the client prefix "
                    f"(captures: {sorted(var_names)})")

    def server_hostname(self, vars_: Optional[Dict[str, str]] = None
                        ) -> Optional[str]:
        """The SNI / verified name, with ``{var}`` substitution applied."""
        if self.commonName is None:
            return None
        from linkerd_tpu_torch.core.pathmatcher import PathMatcher
        sub = PathMatcher.substitute_vars(vars_ or {}, self.commonName)
        if sub is None:
            # An unresolved {var} must not silently become a literal SNI
            # string — that fails every handshake with an opaque mismatch.
            raise ConfigError(
                f"tls commonName {self.commonName!r} references variables "
                f"not captured by the client prefix (have: "
                f"{sorted(vars_ or {})})")
        return sub


def _record_sni(sslobj, server_name, _ctx) -> None:
    """sni_callback installed on every server context: stash the
    client's requested server name on the SSLObject so the asyncio
    servers can surface it into ``req.ctx["sni"]`` (the Python
    data plane's half of ``tenantIdentifier: sni`` — the native
    engines read it via SSL_get_servername). Returning None proceeds
    with the handshake unchanged."""
    sslobj._l5d_sni = server_name  # noqa: SLF001 — our own marker attr


def sni_of(transport_or_writer) -> Optional[str]:
    """The SNI a TLS peer sent on this server-side connection, or None
    (cleartext conn, no SNI extension, or a context built outside
    TlsServerConfig.mk_context)."""
    get = getattr(transport_or_writer, "get_extra_info", None)
    if get is None:
        return None
    sslobj = get("ssl_object")
    if sslobj is None:
        return None
    return getattr(sslobj, "_l5d_sni", None) or None


@dataclass
class TlsServerConfig:
    """Server-side TLS termination (ref: TlsServerConfig.scala)."""

    certPath: str = ""
    keyPath: str = ""
    caCertPath: Optional[str] = None  # set -> require + verify client certs

    def mk_context(self) -> ssl.SSLContext:
        if not self.certPath or not self.keyPath:
            raise ConfigError("tls server config needs certPath and keyPath")
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certPath, self.keyPath)
        if self.caCertPath:
            ctx.load_verify_locations(cafile=self.caCertPath)
            ctx.verify_mode = ssl.CERT_REQUIRED
        # surface SNI to the data plane (tenantIdentifier: sni parity
        # with the native engines)
        ctx.sni_callback = _record_sni
        return ctx
