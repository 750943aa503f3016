"""Fleet-scheduler CLI of the PyTorch port: N fine-tuning jobs on one
shared, flaky pool (counterpart of ``repro.launch.fleet``).

Drives :class:`repro_torch.fleet.FleetScheduler` under a deterministic
failure simulation: a pool of devices, a queue of jobs, and a
:class:`~repro_torch.fleet.events.FaultPlan` of scripted join/leave/
slow/kill/submit events pinned to scheduler ticks (one tick = one step
boundary), all on a virtual :class:`~repro_torch.fleet.clock.SimClock` —
every run of the same plan replays identically. It runs on the card
unless ``--device cpu``:

    # two jobs, four devices, one device killed mid-run
    PYTHONPATH=src python -m repro_torch.launch.fleet --simulate --device cpu \\
        --reduced --pool 4 --jobs 2 --epochs 3 --steps-per-epoch 2 --batch 4 \\
        --seq 16 --kill-tick 8

    # replay an explicit fault script (JSON, either package's; see --save-fault-plan)
    PYTHONPATH=src python -m repro_torch.launch.fleet --simulate --device cpu \\
        --reduced --fault-plan faults.json --jobs 2

Without ``--fault-plan`` a default script is generated: job *i* is
submitted at tick ``2·i``, and (when ``--kill-tick`` is set) the pool's
last device is killed at that tick — it silently stops heartbeating and
is evicted only after the heartbeat timeout, exactly as a real loss
would play out. Cached epochs keep running through the kill: the
elastic DP runner reshards the chunk placement onto the survivors with
bit-identical numerics (``repro_torch.fleet.elastic``), so the printed
losses match a fault-free run float for float.

``--bind-devices`` gives member *k* (by join slot) ``cuda:k`` when that
card exists; members beyond the cards present, and every member without
the flag, share the base device (``--device``, default the card).
``--kernels cuda`` (the default) runs the capture steps' frozen forward
and every chunk of the cached steps through the CUDA kernels;
``--kernels ref`` is plain PyTorch.
"""

from __future__ import annotations

import argparse


def default_fault_plan(n_jobs: int, pool: list, kill_tick=None):
    """submit job-i at tick 2i; optionally kill the last device."""
    from repro_torch.fleet import FaultPlan, FleetEvent

    events = [FleetEvent(2 * i, "submit", job=f"job{i}")
              for i in range(n_jobs)]
    if kill_tick is not None and pool:
        events.append(FleetEvent(kill_tick, "kill", device=pool[-1]))
    return FaultPlan(events)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--simulate", action="store_true", required=True,
                    help="run the deterministic failure simulation (the only "
                         "mode; the flag is explicit so a future live mode "
                         "can default differently)")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", help="CPU-scale variant")
    ap.add_argument("--pool", type=int, default=4, help="initial device count")
    ap.add_argument("--jobs", type=int, default=2, help="jobs to submit")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--steps-per-epoch", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--r", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0,
                    help="job i runs with seed+i (distinct corpora)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="sequences per elastic work unit (batch %% chunk == 0)")
    ap.add_argument("--quantum", type=int, default=None,
                    help="preempt a running job after this many ticks when "
                         "others wait (checkpointed via --snapshot-dir)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="preemption snapshots go here (default: in-memory)")
    ap.add_argument("--cache-dir", default=None,
                    help="per-job persistent activation caches under this dir "
                         "(<dir>/job0, ...) — a rerun resumes warm with zero "
                         "backbone forwards")
    ap.add_argument("--cache-compress", default="f32",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--kernels", default="cuda", choices=["cuda", "ref"],
                    help="'cuda' = the hand-written kernels; 'ref' = plain PyTorch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; no silent CPU fallback)")
    ap.add_argument("--heartbeat-timeout", type=float, default=1.5,
                    help="simulated seconds without a heartbeat before a "
                         "device is declared lost (ticks advance 1s each)")
    ap.add_argument("--kill-tick", type=int, default=None,
                    help="kill the pool's last device at this tick "
                         "(ignored with --fault-plan)")
    ap.add_argument("--fault-plan", default=None,
                    help="JSON fault script to replay (FaultPlan.save format)")
    ap.add_argument("--save-fault-plan", default=None,
                    help="write the executed fault script as JSON")
    ap.add_argument("--bind-devices", action="store_true",
                    help="member k (by join slot) runs on cuda:k when that card exists")
    ap.add_argument("--max-ticks", type=int, default=200)
    args = ap.parse_args(argv)

    from repro_torch.fleet import (
        DeviceMember,
        DevicePool,
        FaultPlan,
        FleetScheduler,
        ScriptedEvents,
        SessionJob,
        SimClock,
    )
    from repro_torch.runtime import RunSpec, RunSpecError

    member_names = [f"dev{i}" for i in range(args.pool)]
    if args.fault_plan:
        plan = FaultPlan.load(args.fault_plan)
    else:
        plan = default_fault_plan(args.jobs, member_names, args.kill_tick)
    if args.save_fault_plan:
        print(f"fault plan saved: {plan.save(args.save_fault_plan)}")

    # the pool resolves the device first: no card and no --device cpu refuses here
    pool = DevicePool(
        [DeviceMember(n) for n in member_names], clock=SimClock(),
        heartbeat_timeout=args.heartbeat_timeout,
        bind_devices=args.bind_devices, device=args.device)
    sched = FleetScheduler(
        pool, events=ScriptedEvents(plan), quantum=args.quantum,
        snapshot_dir=args.snapshot_dir, max_ticks=args.max_ticks, log=print)

    try:
        base = RunSpec(
            arch=args.arch, reduced=args.reduced, epochs=args.epochs,
            steps_per_epoch=args.steps_per_epoch, batch=args.batch, seq=args.seq,
            r=args.r, lr=args.lr, cache_compress=args.cache_compress,
            kernels=args.kernels).validate()
        for i in range(args.jobs):
            spec = base.replace(
                seed=args.seed + i,
                cache_dir=f"{args.cache_dir}/job{i}" if args.cache_dir else None)
            sched.register(SessionJob(f"job{i}", spec, chunk=args.chunk,
                                      device=args.device))
    except RunSpecError as e:
        raise SystemExit(str(e))

    report = sched.run()

    print(f"\nfleet: {report.n_ticks} ticks, "
          f"{len(pool)} devices remain, "
          f"{len(report.rejected)} rejected")
    for name in sorted(sched.jobs):
        job = sched.jobs[name]
        losses = report.losses(name)
        final = f"{losses[-1]:.4f}" if losses else "-"
        print(f"  {name}: {job.state} steps={report.job_steps(name)} "
              f"forwards={job.forward_steps} cached={job.cached_steps} "
              f"reshards={job.reshards} final_loss={final}")


if __name__ == "__main__":
    main()
