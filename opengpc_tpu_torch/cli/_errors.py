"""Uniform input-error reporting for the console scripts.

The library raises typed errors for every bad input (ValueError for
malformed forests / artifacts / settings, OSError for missing, unreadable,
or corrupt files) and the CLIs already print one-line messages for the errors they
anticipate inline.  This guard makes the *unanticipated* input errors
consistent with those: a missing forest path or a corrupt PNG exits 1
with ``error: <message>`` instead of a raw traceback.  The reference
performs no input validation at all (``samples/sparsematch.cpp:29-42``
passes argv straight into readForest/readPNG).

Set ``OGPC_CLI_TRACEBACK=1`` to re-raise and get the full traceback when
debugging.
"""

from __future__ import annotations

import functools
import os
import sys


def report_input_errors(main):
    """Wrap a CLI ``main(argv) -> int`` so typed input errors print as
    one-line ``error:`` messages with exit code 1 (tracebacks via
    ``OGPC_CLI_TRACEBACK=1``)."""

    @functools.wraps(main)
    def wrapped(argv=None):
        try:
            return main(argv)
        except (OSError, ValueError) as e:
            if os.environ.get("OGPC_CLI_TRACEBACK", "") not in ("", "0"):
                raise
            print(f"error: {e}", file=sys.stderr)
            return 1

    return wrapped
