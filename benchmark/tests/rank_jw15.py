"""jw_15km as the tests of its check run it (test_bench_patch.py): the
configuration's own build and check, with a fault on the rank that owns
the first patch centre where the traffic names one: {"at": "exchange", "which":
k}: in the sampled step that rank keeps its own halo rows of the k-th
exchange (it sends and receives, and drops what it received);
{"at": "u"}: after the sampled step that rank's u is 1% larger."""

import dataclasses

from benchmark.harness import common

JW15 = common.config_module("jw_15km")
prepare, bytes_per_step, check = JW15.prepare, JW15.bytes_per_step, \
    JW15.check


class _Stale:
    """An exchange whose call number `which` returns its field as it was
    (the exchange itself still runs, so the other ranks go on)."""

    def __init__(self, xch, which):
        self.xch, self.which, self.calls = xch, which, 0

    def __getattr__(self, kind):
        def call(x, depth=None):
            out = getattr(self.xch, kind)(x, depth)
            self.calls += 1
            return x if self.calls == self.which else out
        return call


def build(params, traffic, seed, device, group=None):
    case = JW15.build(params, traffic, seed, device, group=group)
    fault = traffic.get("fault")
    mine = case.group.loopback or case.part[case.centres[0]] \
        == case.group.rank
    if not fault or not mine:
        return case
    snapshot, step = case.snapshot, case.step
    taken = []

    def counted():
        taken.append(None)
        return snapshot()

    def broken():
        sampled = len(taken) == 2          # between the 2nd and 3rd
        if sampled and fault["at"] == "exchange":
            xch, case.xch = case.xch, _Stale(case.xch, fault["which"])
            step()
            case.xch = xch
            return
        step()
        if sampled and fault["at"] == "u":
            s = case.carry.state
            case.carry = dataclasses.replace(case.carry, state=dataclasses
                                             .replace(s, u=s.u * 1.01))
    case.snapshot, case.step = counted, broken
    return case
