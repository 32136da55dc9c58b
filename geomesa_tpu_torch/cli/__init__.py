"""Command-line tools: the ``geomesa-tpu-torch`` CLI, the port's copy of
the JAX package's ``geomesa-tpu``.

Capability match for the reference's JCommander command tree
(geomesa-tools/.../Runner.scala:21-146: create-schema / ingest / export /
explain / stats-* / delete-*), argparse-based, operating on a filesystem
catalog directory instead of a cluster connection.
"""

from .main import main

__all__ = ["main"]
