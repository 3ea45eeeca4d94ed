"""Calendars, model time, clocks and alarms (port of
mpas_tpu/framework/timekeeping.py: the same code, kept here so that the
port imports nothing of the JAX package).

Replacement for the vendored ESMF time manager + its wrapper
(ref: src/external/esmf_time_f90/ESMF_TimeMod.F90, ESMF_ClockMod.F90;
src/framework/mpas_timekeeping.F: MPAS_Time/TimeInterval/Clock/Alarm types
:14-42 of mpas_timekeeping_types.inc, clock create/advance :160,381, alarms
:474-1118, ISO parsing mpas_set_time :1119 / mpas_set_timeInterval :1304).

Design: exact integer arithmetic — times are microseconds since the calendar
epoch 0000-01-01_00:00:00; intervals are (months, microseconds) so both
fixed-length ('6:00:00', config_dt=172.8s) and calendar-length ('1 month')
intervals are exact. Host-side only (never traced).

Calendars: 'gregorian', 'gregorian_noleap', '360day'
(ref: mpas_timekeeping.F MPAS_GREGORIAN/_NOLEAP/_360DAY).
"""

from __future__ import annotations

import dataclasses
import re

US = 1_000_000
_DAY = 86400 * US

_MONTH_DAYS_NOLEAP = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
_MONTH_DAYS_LEAP = [31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]

CALENDARS = ("gregorian", "gregorian_noleap", "360day")


def _is_leap(year: int) -> bool:
    return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)


def _month_lengths(cal: str, year: int):
    if cal == "360day":
        return [30] * 12
    if cal == "gregorian" and _is_leap(year):
        return _MONTH_DAYS_LEAP
    return _MONTH_DAYS_NOLEAP


def _days_in_year(cal: str, year: int) -> int:
    if cal == "360day":
        return 360
    if cal == "gregorian" and _is_leap(year):
        return 366
    return 365


def _ymd_to_days(cal: str, y: int, m: int, d: int) -> int:
    """Days since 0000-01-01 in the given calendar."""
    if cal == "360day":
        days = y * 360
    elif cal == "gregorian_noleap":
        days = y * 365
    else:
        # gregorian: count leap years in [0, y)
        if y > 0:
            leaps = (y + 3) // 4 - (y + 99) // 100 + (y + 399) // 400
        else:
            leaps = -((-y) // 4) + ((-y) // 100) - ((-y) // 400)
        days = y * 365 + leaps
    ml = _month_lengths(cal, y)
    days += sum(ml[: m - 1]) + (d - 1)
    return days


def _days_to_ymd(cal: str, days: int):
    # coarse year guess then adjust
    y = days // 366 if cal == "gregorian" else \
        days // (360 if cal == "360day" else 365)
    while _ymd_to_days(cal, y + 1, 1, 1) <= days:
        y += 1
    while _ymd_to_days(cal, y, 1, 1) > days:
        y -= 1
    rem = days - _ymd_to_days(cal, y, 1, 1)
    ml = _month_lengths(cal, y)
    m = 1
    while rem >= ml[m - 1]:
        rem -= ml[m - 1]
        m += 1
    return y, m, rem + 1


_TIME_RE = re.compile(
    r"^\s*(-?\d+)-(\d+)-(\d+)[_ ](\d+):(\d+):(\d+(?:\.\d+)?)\s*$")
# interval: [[DDD_]hh:mm:ss[.frac]] (reference 'd_h:m:s' form) or pure seconds
_IVAL_RE = re.compile(
    r"^\s*(?:(\d+)_)?(\d+):(\d+):(\d+(?:\.\d+)?)\s*$")


@dataclasses.dataclass(frozen=True, order=False)
class Time:
    """An instant: microseconds since 0000-01-01_00:00:00 (calendar-aware)."""
    us: int
    calendar: str = "gregorian_noleap"

    @staticmethod
    def from_string(s: str, calendar: str = "gregorian_noleap") -> "Time":
        m = _TIME_RE.match(s)
        if not m:
            raise ValueError(f"unparseable time string: {s!r}")
        y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
        hh, mm = int(m.group(4)), int(m.group(5))
        ss = float(m.group(6))
        us = _ymd_to_days(calendar, y, mo, d) * _DAY \
            + (hh * 3600 + mm * 60) * US + round(ss * US)
        return Time(us, calendar)

    def to_string(self) -> str:
        days, rem = divmod(self.us, _DAY)
        y, mo, d = _days_to_ymd(self.calendar, days)
        sec, frac = divmod(rem, US)
        hh, r = divmod(sec, 3600)
        mm, ss = divmod(r, 60)
        base = f"{y:04d}-{mo:02d}-{d:02d}_{hh:02d}:{mm:02d}:{ss:02d}"
        if frac:
            base += f".{frac:06d}".rstrip("0")
        return base

    def __add__(self, iv: "TimeInterval") -> "Time":
        us = self.us
        if iv.months:
            days, rem = divmod(us, _DAY)
            y, mo, d = _days_to_ymd(self.calendar, days)
            total = (y * 12 + (mo - 1)) + iv.months
            y2, mo2 = divmod(total, 12)
            ml = _month_lengths(self.calendar, y2)
            d2 = min(d, ml[mo2])
            us = _ymd_to_days(self.calendar, y2, mo2 + 1, d2) * _DAY + rem
        return Time(us + iv.us, self.calendar)

    def __sub__(self, other):
        if isinstance(other, TimeInterval):
            return self + TimeInterval(-other.months, -other.us)
        return TimeInterval(0, self.us - other.us)

    def __lt__(self, o): return self.us < o.us
    def __le__(self, o): return self.us <= o.us
    def __gt__(self, o): return self.us > o.us
    def __ge__(self, o): return self.us >= o.us


@dataclasses.dataclass(frozen=True)
class TimeInterval:
    months: int = 0
    us: int = 0

    @staticmethod
    def from_string(s: str) -> "TimeInterval":
        m = _IVAL_RE.match(s)
        if m:
            d = int(m.group(1) or 0)
            hh, mm = int(m.group(2)), int(m.group(3))
            ss = float(m.group(4))
            return TimeInterval(0, d * _DAY + (hh * 3600 + mm * 60) * US
                                + round(ss * US))
        tm = _TIME_RE.match(s)  # 'YYYY-MM-DD_hh:mm:ss' calendar interval
        if tm:
            y, mo, d = int(tm.group(1)), int(tm.group(2)), int(tm.group(3))
            hh, mm = int(tm.group(4)), int(tm.group(5))
            ss = float(tm.group(6))
            return TimeInterval(y * 12 + mo,
                                d * _DAY + (hh * 3600 + mm * 60) * US
                                + round(ss * US))
        raise ValueError(f"unparseable interval string: {s!r}")

    @staticmethod
    def from_seconds(sec: float) -> "TimeInterval":
        return TimeInterval(0, round(sec * US))

    def total_seconds(self) -> float:
        if self.months:
            raise ValueError("month-bearing interval has no fixed seconds")
        return self.us / US

    def __mul__(self, k: int):
        return TimeInterval(self.months * k, self.us * k)

    def __neg__(self):
        return TimeInterval(-self.months, -self.us)

    def __bool__(self):
        return bool(self.months or self.us)


@dataclasses.dataclass
class Alarm:
    """One-shot or periodic alarm (ref: mpas_timekeeping.F:474-1118)."""
    name: str
    ring_time: Time | None = None          # one-shot
    interval: TimeInterval | None = None   # periodic
    reference: Time | None = None
    stopped: bool = False

    def is_ringing(self, now: Time) -> bool:
        if self.stopped:
            return False
        if self.interval is None:
            return self.ring_time is not None and now >= self.ring_time
        # periodic: ring when now is at/past the next multiple since reference
        return now >= self._next_ring_on_or_before(now)

    def _next_ring_on_or_before(self, now: Time) -> Time:
        assert self.reference is not None and self.interval is not None
        if self.interval.months:
            t = self.reference
            while t + self.interval <= now:
                t = t + self.interval
            return t if t <= now else self.reference
        span = now.us - self.reference.us
        k = span // self.interval.us if span >= 0 else 0
        return Time(self.reference.us + k * self.interval.us, now.calendar)

    def reset(self, now: Time):
        """Advance reference past `now` (ref: mpas_reset_clock_alarm)."""
        if self.interval is None:
            self.stopped = True
        else:
            self.reference = self._next_ring_on_or_before(now) + self.interval
            # keep reference ahead of now so the alarm stops ringing
            while self.reference <= now:
                self.reference = self.reference + self.interval


class Clock:
    """Model clock (ref: mpas_create_clock :160, mpas_advance_clock :381)."""

    def __init__(self, start_time: Time, dt: TimeInterval,
                 stop_time: Time | None = None,
                 run_duration: TimeInterval | None = None):
        self.start_time = start_time
        self.dt = dt
        if run_duration is not None:
            self.stop_time = start_time + run_duration
        else:
            self.stop_time = stop_time
        self.now = start_time
        self.alarms: dict[str, Alarm] = {}

    def add_alarm(self, alarm: Alarm):
        self.alarms[alarm.name] = alarm

    def advance(self, n: int = 1):
        self.now = self.now + self.dt * n

    def is_stop_time(self) -> bool:
        return self.stop_time is not None and self.now >= self.stop_time

    def is_ringing(self, name: str) -> bool:
        return self.alarms[name].is_ringing(self.now)

    def reset_alarm(self, name: str):
        self.alarms[name].reset(self.now)

    def steps_until_stop(self) -> int:
        if self.stop_time is None:
            raise ValueError("clock has no stop time")
        span = self.stop_time.us - self.now.us
        if self.dt.months:
            raise ValueError("month-length dt unsupported for step count")
        return max(0, -(-span // self.dt.us)) if span > 0 else 0
