"""Authorization providers — the port's copy of the JAX package's
``security/auth.py`` (the reference's AuthorizationsProvider SPI,
geomesa-security/.../security/package.scala + AuthorizationsProvider
implementations)."""

from __future__ import annotations

from typing import Protocol, runtime_checkable

__all__ = ["AuthorizationsProvider", "StaticAuthorizationsProvider"]


@runtime_checkable
class AuthorizationsProvider(Protocol):
    """Supplies the authorization labels for the current caller."""

    def get_authorizations(self) -> frozenset:  # pragma: no cover - protocol
        ...


class StaticAuthorizationsProvider:
    """Fixed auth set (the DefaultAuthorizationsProvider analog)."""

    def __init__(self, auths=()):
        self._auths = frozenset(auths)

    def get_authorizations(self) -> frozenset:
        return self._auths
