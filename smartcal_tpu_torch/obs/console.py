"""The console output site of the port (counterpart of
smartcal_tpu/obs/console.py).

Human diagnostics go through :func:`echo` (stderr, plus a structured
``log`` event when a RunLog is active, silenced by ``quiet``); machine
payloads go through :func:`emit_json` (one JSON line on stdout, mirrored
into the RunLog).
"""

import json
import sys

from .runlog import active, sanitize


def echo(msg: object, quiet: bool = False,
         event: "str | None" = "log", **fields: object) -> None:
    """Stderr echo (unless ``quiet``) plus a structured event when recording;
    ``event=None`` skips the event (its content is logged elsewhere)."""
    rl = active()
    if rl is not None and event is not None:
        rl.log(event, msg=str(msg), **fields)
    if not quiet:
        print(msg, file=sys.stderr, flush=True)


def emit_json(payload: dict, event: str = "result") -> None:
    """One JSON result line on stdout, mirrored into the active RunLog."""
    rl = active()
    if rl is not None:
        rl.log(event, **payload)
    print(json.dumps(sanitize(payload)), flush=True)
