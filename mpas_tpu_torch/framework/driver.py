"""Top-level run driver: init -> run loop -> finalize (port of
mpas_tpu/framework/driver.py).

The reference driver/subdriver (ref: src/driver/mpas.F:8-22, a 3-call
program, and mpas_subdriver.F:45-398: namelist read, clock setup, stream
setup, core init, alarm-driven run loop, restart handling, finalize with
the timer table). One driver serves every core through a small CoreHooks
protocol, like the reference's core_type function-pointer suite (ref:
mpas_core_types.inc:146-178).

The run's state lives on one torch device, cuda:0 unless the caller names
another; nothing falls back to the CPU. Where the device is a CUDA card
the timers synchronise it, so that "time integration" measures the steps
and not only their dispatch. The chunking of the run loop and the restart
timestamp are the reference package's, so chunk boundaries and file names
match its runs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import torch

from mpas_tpu_torch.containers import resolve_device
from mpas_tpu_torch.framework.log import LogManager
from mpas_tpu_torch.framework.streams import Stream, StreamManager
from mpas_tpu_torch.framework.timekeeping import Clock, Time, TimeInterval
from mpas_tpu_torch.framework.timers import TimerManager


@dataclasses.dataclass
class CoreHooks:
    """The core_type function-pointer suite equivalent."""
    name: str
    config_cls: type
    setup: Callable          # (cfg, mesh_spec, device, dtype) -> core_state
    step_chunk: Callable     # (core_state, n_steps) -> core_state
    output_fields: Callable  # (core_state) -> ({name: (dims, array)}, dims)
    restart_fields: Callable  # like output_fields but complete for resume
    resume: Callable         # (core_state, data) -> core_state
    # optional per-chunk summary line (ref: summarize_timestep,
    # mpas_atm_time_integration.F:6675 — global w/precip extremes)
    summarize: Callable = None


def _float_leaves(obj, name):
    """(name, tensor) of every floating tensor in nested dataclasses."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            yield name, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _float_leaves(getattr(obj, f.name), f"{name}.{f.name}")


class Driver:
    def __init__(self, hooks: CoreHooks, cfg, run_dir: str = ".",
                 streams: list | None = None, mesh_spec: str = "icos:8",
                 device=None, dtype=torch.float32):
        self.hooks = hooks
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.log = LogManager(hooks.name, run_dir=run_dir)
        self.timers = TimerManager(self.device)

        # Map MPAS namelist calendar names (mpas_timekeeping.F:160 accepts
        # 'gregorian', 'gregorian_noleap', '360day') to timekeeping names.
        calendar = getattr(cfg, "config_calendar_type", "gregorian_noleap")
        calendar = {"360_day": "360day", "noleap": "gregorian_noleap"}.get(
            calendar, calendar)
        start = Time.from_string(
            getattr(cfg, "config_start_time", "0000-01-01_00:00:00"),
            calendar)
        dt = TimeInterval.from_seconds(cfg.config_dt)
        duration = getattr(cfg, "config_run_duration", "none")
        stop = getattr(cfg, "config_stop_time", "none")
        self.clock = Clock(
            start, dt,
            stop_time=None if stop in ("none", None)
            else Time.from_string(stop, calendar),
            run_duration=None if duration in ("none", None)
            else TimeInterval.from_string(duration))
        self.streams = StreamManager(self.clock, run_dir=run_dir)
        for s in (streams or self._default_streams()):
            self.streams.add_stream(s)
        self.mesh_spec = mesh_spec
        self.state = None

    def _default_streams(self):
        """ref: the registry-generated immutable streams (output + restart;
        e.g. core_sw/Registry.xml:57+, core_atmosphere restart stream
        Registry.xml:525-530)."""
        return [
            Stream(name="output", direction="output",
                   filename_template=f"output.{self.hooks.name}."
                   "$Y-$M-$D_$h.$m.$s.nc",
                   fields=[], output_interval="6:00:00"),
            Stream(name="restart", direction="input;output",
                   filename_template=f"restart.{self.hooks.name}."
                   "$Y-$M-$D_$h.$m.$s.nc",
                   fields=[], output_interval="1_00:00:00"),
        ]

    def init(self):
        """ref: mpas_init (mpas_subdriver.F:45)."""
        with self.timers.timer("initialize"):
            self.log.write(f"** {self.hooks.name} core init, mesh "
                           f"{self.mesh_spec}, {self.device}, {self.dtype}")
            self.state = self.hooks.setup(self.cfg, self.mesh_spec,
                                          self.device, self.dtype)
            if getattr(self.cfg, "config_do_restart", False):
                data, _, _ = self.streams.read("restart")
                self.state = self.hooks.resume(self.state, data)
                self.log.write("Restarted from restart stream at "
                               + self.clock.now.to_string())
        return self

    def _write_stream(self, name, fields_fn, force=False):
        fields, dims = fields_fn(self.state)
        stream = self.streams.streams[name]
        if not stream.fields:
            stream.fields = list(fields.keys())
        fname = self.streams.write(
            name, lambda f: fields[f], dims=dims, force=force,
            attrs={"model_name": "mpas_tpu_torch",
                   "core_name": self.hooks.name, "conventions": "MPAS"})
        if fname:
            self.log.write(f"wrote stream {name}: {os.path.basename(fname)}")
        return fname

    def _debug_check_state(self, step):
        """NaN/Inf sweep over the core state (ref: MPAS_DEBUG +
        -ffpe-trap=invalid,zero,overflow debug builds; here a post-chunk
        validation). Core states are opaque to the driver, so the sweep
        walks their dataclasses; every leaf's all-finite flag is stacked
        on the device and read back at once."""
        leaves = list(_float_leaves(self.state, "state"))
        if not leaves:
            return
        finite = torch.stack([t.isfinite().all().to(self.device)
                              for _, t in leaves]).tolist()
        for (name, t), ok in zip(leaves, finite):
            if not ok:
                n_bad = int((~t.isfinite()).sum())
                # CRIT -> abort (ref: mpas_log_write(..., MPAS_LOG_CRIT)
                # -> mpas_dmpar_global_abort)
                self.log.write(
                    f"debug check failed at step {step}: {n_bad} "
                    f"non-finite values in state leaf {name}",
                    message_type="CRIT")

    def run(self):
        """Alarm-driven run loop (ref: core_run patterns, e.g.
        atm_core_run mpas_atm_core.F:476)."""
        self._write_stream("output", self.hooks.output_fields, force=True)
        n_total = self.clock.steps_until_stop()
        self.log.write(f"running {n_total} steps of dt={self.cfg.config_dt}s")
        t_wall = time.time()
        done = 0
        while not self.clock.is_stop_time():
            # advance to the next ringing alarm in one chunk
            remaining = self.clock.steps_until_stop()
            chunk = remaining
            for nm in self.clock.alarms:
                a = self.clock.alarms[nm]
                if a.interval is not None and a.interval.us > 0:
                    nxt = a._next_ring_on_or_before(self.clock.now)
                    while nxt <= self.clock.now:
                        nxt = nxt + a.interval
                    steps_to = -((self.clock.now.us - nxt.us)
                                 // self.clock.dt.us)
                    chunk = min(chunk, max(1, steps_to))
            with self.timers.timer("time integration"):
                self.state = self.hooks.step_chunk(self.state, chunk)
            if getattr(self.cfg, "config_debug_checks", False):
                # debug/validation mode (ref: the MPAS_DEBUG build flag +
                # -ffpe-trap debug builds, SURVEY §5.2): sweep the state
                # for non-finite values after every chunk and abort
                # through the CRIT path with the offending leaf
                with self.timers.timer("debug checks"):
                    self._debug_check_state(done + chunk)
            self.clock.advance(chunk)
            done += chunk
            with self.timers.timer("stream output"):
                for name, fn in (("output", self.hooks.output_fields),
                                 ("restart", self.hooks.restart_fields)):
                    if self.streams.should_write(name):
                        self._write_stream(name, fn)
                        if name == "restart":
                            # ref: restart_timestamp written after success
                            # (mpas_atm_core.F:738-744)
                            with open(os.path.join(self.run_dir,
                                                   "restart_timestamp"),
                                      "w") as f:
                                f.write(self.clock.now.to_string() + "\n")
            extra = ""
            if self.hooks.summarize is not None:
                extra = " " + self.hooks.summarize(self.state)
            self.log.write(f"completed step {done}/{n_total} "
                           f"({self.clock.now.to_string()}){extra}")
        self.log.write(f"run finished in {time.time()-t_wall:.1f}s wall")
        return self

    def finalize(self):
        """ref: mpas_finalize (mpas_subdriver.F:355): final output + timer
        table; closes the log file."""
        self._write_stream("output", self.hooks.output_fields, force=True)
        self.log.write("timer table:\n" + self.timers.table())
        self.log.close()
        return self
