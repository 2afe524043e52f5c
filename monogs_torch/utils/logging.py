"""Tagged console logging (port of monogs_tpu/utils/logging.py).

`Log(*args, tag=...)` prints a time stamp and a coloured tag to stderr,
through rich where it is installed and plain print otherwise; the tags
named in MONOGS_QUIET_TAGS (comma-separated) are silenced. `WandbLogger`
logs run metrics to wandb when a run enables it and the package imports,
and is a silent no-op otherwise.
"""

from __future__ import annotations

import os
import sys
import time

_TAG_STYLES = {
    "MonoGS": "bold green",
    "Tracker": "bold cyan",
    "Mapper": "bold magenta",
    "System": "bold yellow",
    "Eval": "bold blue",
    "Bench": "bold white",
}

_QUIET_TAGS = set(os.environ.get("MONOGS_QUIET_TAGS", "").split(",")) - {""}

try:
    from rich.console import Console

    _console = Console(file=sys.stderr)
except ImportError:
    _console = None

_T0 = time.time()


class WandbLogger:
    """wandb metric logging, gated by Results.use_wandb: a project run with
    frame_idx as the step metric of the ate* metrics. A no-op when disabled
    or when wandb does not import."""

    def __init__(self, enabled: bool = False, project: str = "monogs_torch",
                 name: str | None = None, config: dict | None = None):
        self._wandb = None
        if not enabled:
            return
        try:
            import wandb
        except ImportError as e:
            Log(f"wandb disabled: {e}", tag="System")
            return
        wandb.init(project=project, name=name, config=config)
        wandb.define_metric("frame_idx")
        wandb.define_metric("ate*", step_metric="frame_idx")
        self._wandb = wandb

    def log(self, metrics: dict):
        if self._wandb is not None:
            self._wandb.log(metrics)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()


def Log(*args, tag: str = "MonoGS"):
    if tag in _QUIET_TAGS:
        return
    stamp = f"[{time.time() - _T0:8.2f}s]"
    if _console is not None:
        style = _TAG_STYLES.get(tag, "bold white")
        _console.print(f"{stamp} [{style}]\\[{tag}][/{style}]", *args)
    else:
        print(stamp, f"[{tag}]", *args, file=sys.stderr)
