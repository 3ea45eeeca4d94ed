"""Run logging (port of mpas_tpu/framework/log.py).

ref: src/framework/mpas_log.F: per-core `log.<core>.<rank>.out` files,
master-only default, OUT/WARN/ERR/CRIT message types, critical -> abort.
Python logging underneath; CRIT raises (the reference calls
mpas_dmpar_global_abort -> MPI_Abort; here an exception unwinds the run).
"""

from __future__ import annotations

import logging
import os
import sys


class MPASLogError(RuntimeError):
    """Raised on CRIT messages (ref: mpas_log.F critical->abort path)."""


class LogManager:
    def __init__(self, core_name: str, run_dir: str = ".",
                 rank: int = 0, master_only: bool = True,
                 to_stderr: bool = False):
        self.core_name = core_name
        self.rank = rank
        self.active = (rank == 0) or not master_only
        self.logger = logging.getLogger(f"mpas_tpu_torch.{core_name}.{rank}")
        self.logger.setLevel(logging.INFO)
        self.close()
        if self.active:
            path = os.path.join(run_dir, f"log.{core_name}.{rank:04d}.out")
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter("%(message)s"))
            self.logger.addHandler(fh)
            if to_stderr:
                self.logger.addHandler(logging.StreamHandler(sys.stderr))
        self.logger.propagate = False

    def close(self):
        """Close and drop the handlers (the log file stays on disk)."""
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()

    def write(self, message: str, message_type: str = "OUT", **fmt):
        """message_type in OUT|WARN|ERR|CRIT; $-style substitution via
        str.format kwargs (the reference uses $i/$r/$l positional args)."""
        msg = message.format(**fmt) if fmt else message
        if message_type == "OUT":
            self.logger.info(msg)
        elif message_type == "WARN":
            self.logger.warning("WARNING: " + msg)
        elif message_type == "ERR":
            self.logger.error("ERROR: " + msg)
        elif message_type == "CRIT":
            self.logger.critical("CRITICAL ERROR: " + msg)
            raise MPASLogError(msg)
        else:
            raise ValueError(f"unknown message type {message_type}")
