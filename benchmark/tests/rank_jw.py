"""jw_120km as the tests of the rank path run it (test_bench_ranks.py on
the CPU, test_bench_cuda.py on the cards): the configuration's own build,
with a fault where the traffic names one ({"rank": r, "at": "build"};
{"rank": r, "at": "step", "step": k}: the k-th step of the window;
{"rank": r, "at": "finite"}: the rank reads its state as not finite),
and where the traffic gives a "watch" directory, each rank's log there
of what it does outside its steps (watch); and its own check, with two
numbers more: the state the ranks gathered, at the window's third step
and after the sampled step, against the one-rank run of the program from
the same initial carry (the one the shards were cut from), max
|gathered - one rank| / max |one rank| over every field of the state;
where asked, the same against the port's loopback run of the same shards
(loopback_*) and against the one-card run as a cell on one card runs it,
its initial carry made on the card (card_init_*)."""

from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark.harness import common

JW = common.config_module("jw_120km")
prepare, bytes_per_step = JW.prepare, JW.bytes_per_step

COLLECTIVES = ("barrier", "all_gather", "all_gather_object", "gather",
               "gather_object", "broadcast", "broadcast_object_list",
               "all_reduce", "reduce", "scatter", "scatter_object_list",
               "reduce_scatter", "all_to_all", "all_to_all_single", "send",
               "recv", "batch_isend_irecv")     # isend, irecv: P2POp's
HOST_COPIES = ("cpu", "numpy", "item", "tolist")


class Fault(RuntimeError):
    """The fault the traffic asks for."""


def watch(case, path):
    """From here on this process writes to `path` a line for each call of
    a torch.distributed collective (point-to-point ones as a batch: P2POp
    takes isend and irecv by identity), of torch.cuda.synchronize and of a
    tensor's copy to the host (Tensor.cpu/numpy/item/tolist) made outside
    case.step: a step's own halo exchanges are the program's."""
    import torch.distributed as dist
    log = open(path, "a", buffering=1)
    inside = []

    def wrap(owner, name, label):
        fn = getattr(owner, name)

        def call(*a, **k):
            if not inside:
                log.write(label + "\n")
            return fn(*a, **k)
        setattr(owner, name, call)
    for name in COLLECTIVES:
        if hasattr(dist, name):
            wrap(dist, name, name)
    wrap(torch.cuda, "synchronize", "synchronize")
    for name in HOST_COPIES:
        wrap(torch.Tensor, name, f"Tensor.{name}")
    step = case.step

    def stepped():
        inside.append(None)
        try:
            step()
        finally:
            inside.pop()
    case.step = stepped


def build(params, traffic, seed, device, group=None):
    fault = traffic.get("fault") or {}
    here = group is not None and group.rank == fault.get("rank")
    if here and fault["at"] == "build":
        raise Fault(f"rank {group.rank}: a fault in build")
    case = JW.build(params, traffic, seed, device, group=group)
    if here and fault["at"] == "finite":
        case.finite = lambda: False
    if here and fault["at"] == "step":
        step, calls = case.step, []

        def broken():
            calls.append(None)
            if len(calls) == fault["step"]:
                raise Fault(f"rank {group.rank}: a fault in step "
                            f"{len(calls)} of the window")
            step()
        case.step = broken
    if "watch" in traffic and group is not None:
        watch(case, Path(traffic["watch"]) / f"rank{group.rank}.log")
    return case


def state_gap(got, ref):
    """max over the state's fields of max |got - ref| / max |ref|."""
    return max(float((getattr(got, k).double() - getattr(ref, k).double())
                     .abs().max() / getattr(ref, k).double().abs().max())
               for k in JW.FIELDS)


def state_of(run):
    snap = run.snapshot()
    return (run.gather(snap) if hasattr(run, "gather") else snap).state


def check(params, traffic, inputs, rec, device):
    """JW's numbers, one_rank_start and one_rank_post, and where the
    traffic asks for them loopback_* (traffic["loopback_ranks"]) and
    card_init_* (traffic["card_init"])."""
    out = JW.check(params, traffic, inputs, rec, device)
    impl, dtype = JW.program_impl(), getattr(torch, params["dtype"])
    host = JW.host_init(impl, params, traffic)
    one = JW.JwCase(impl, params, traffic, inputs, device, dtype, host=host)
    runs = {"one_rank": one}
    if traffic.get("card_init"):
        runs["card_init"] = JW.JwCase(impl, params, traffic, inputs, device,
                                      dtype, host=host)
    one.carry = JW.host_carry(impl, params, traffic, inputs, dtype,
                              host).to(device, dtype)
    if "loopback_ranks" in traffic:
        group = SimpleNamespace(rank=None, size=traffic["loopback_ranks"])
        runs["loopback"] = JW.ShardedJwCase(impl, params, traffic, inputs,
                                            device, dtype, group, host)
    for name, run in runs.items():
        while run.steps_done < rec.start_at:
            run.step()
        out[f"{name}_start"] = state_gap(rec.start.state, state_of(run))
        while run.steps_done < rec.sample_at + 1:
            run.step()
        out[f"{name}_post"] = state_gap(rec.post.state, state_of(run))
    return out
