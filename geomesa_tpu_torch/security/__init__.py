"""Visibility / authorization layer — the port's copy of the JAX
package's ``security/`` (the reference's geomesa-security
module: AuthorizationsProvider SPI + VisibilityEvaluator,
geomesa-security/src/main/scala/org/locationtech/geomesa/security/)."""

from .visibility import (
    VisibilityExpression,
    parse_visibility,
    visibility_mask,
)
from .auth import AuthorizationsProvider, StaticAuthorizationsProvider

__all__ = [
    "VisibilityExpression",
    "parse_visibility",
    "visibility_mask",
    "AuthorizationsProvider",
    "StaticAuthorizationsProvider",
]
