"""Serving-fleet control CLI (ref: tools/fleet_ctl.py), the port's copy.

    python -m paddle_tpu_torch.inference.fleet_ctl status FLEET_DIR [--json]
    python -m paddle_tpu_torch.inference.fleet_ctl drain  FLEET_DIR \
        REPLICA_ID [--timeout S]

`status` reads the router's status.json plus the live replica heartbeat
files from FLEET_DIR (the directory passed as FleetRouter(fleet_dir=))
and prints one row per replica: state, tier, outstanding+queued work,
heartbeat age, spin-up compiles — plus the fleet counters (requests,
failures, reroutes, sheds, latency percentiles, scale events, rollout
state). Pure file reads of the standard library's: it never touches the
router process (run with `python -m`, it imports the package first).
The files are the reference's layout, so this CLI and the repository's
tools/fleet_ctl.py read either package's fleet.

`drain` asks the RUNNING router to drain one replica (stop routing to
it, let in-flight work finish, re-route its queue, retire it) by
dropping a command file into FLEET_DIR/ctl/ — the router's watchdog
picks it up within its poll interval. The command waits until
status.json shows the replica retired/dead (or --timeout, default 120s).

Exit codes (both subcommands):
  0  success — status: the fleet is serving (status.json fresh, >= 1
     serving replica); drain: the replica reached retired
  1  unhealthy / failed — status: stale status.json (router gone or
     wedged) or zero serving replicas; drain: timeout, or the replica
     was not drainable
  2  usage error — unknown subcommand, missing FLEET_DIR / status.json,
     unknown replica id
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_STALE_S = 10.0  # status.json older than this = router gone or wedged


def _read_status(fleet_dir):
    path = os.path.join(fleet_dir, 'status.json')
    try:
        with open(path) as f:
            st = json.load(f)
    except (OSError, ValueError):
        return None, float('inf')
    try:
        age = time.time() - os.path.getmtime(path)
    except OSError:
        age = float('inf')
    return st, age


def _read_heartbeats(fleet_dir):
    hb_dir = os.path.join(fleet_dir, 'hb')
    out = {}
    if not os.path.isdir(hb_dir):
        return out
    now = time.time()
    for name in os.listdir(hb_dir):
        if not (name.startswith('replica_') and name.endswith('.json')):
            continue
        path = os.path.join(hb_dir, name)
        try:
            rid = int(name[len('replica_'):-len('.json')])
            with open(path) as f:
                rec = json.load(f)
            rec['age_s'] = now - os.path.getmtime(path)
            out[rid] = rec
        except (OSError, ValueError):
            continue
    return out


def cmd_status(args):
    st, age = _read_status(args.fleet_dir)
    if st is None:
        print('fleet_ctl: no readable status.json under %s — not a '
              'fleet dir (or the router never started)' % args.fleet_dir,
              file=sys.stderr)
        return 2
    beats = _read_heartbeats(args.fleet_dir)
    serving = int(st.get('serving', 0))
    fresh = age <= args.stale_s and not st.get('closed')
    healthy = fresh and serving >= 1
    if args.json:
        print(json.dumps({'healthy': healthy, 'status_age_s': age,
                          'status': st, 'heartbeats': beats},
                         default=str))
        return 0 if healthy else 1
    c = st.get('counters', {})
    print('fleet      : %s (kind=%s tier=%s)'
          % (st.get('artifact'), st.get('kind'), st.get('tier')))
    print('router     : pid %s, status age %.1fs%s'
          % (st.get('pid'), age, ' [CLOSED]' if st.get('closed') else
             ('' if fresh else ' [STALE — router gone or wedged]')))
    print('health     : %s (%d serving replica(s))'
          % ('OK' if healthy else 'UNHEALTHY', serving))
    print('requests   : %d completed, %d failed, %d rerouted, %d shed, '
          '%d expired' % (c.get('completed', 0), c.get('failed', 0),
                          c.get('rerouted', 0), c.get('shed', 0),
                          c.get('expired', 0)))
    print('latency    : p50 %.2fms p99 %.2fms  ttft p99 %.2fms'
          % (c.get('p50_ms', 0.0), c.get('p99_ms', 0.0),
             c.get('ttft_p99_ms', 0.0)))
    print('scale      : %d out / %d in, %d replica death(s); rollout %s'
          % (c.get('scale_out', 0), c.get('scale_in', 0),
             c.get('replica_deaths', 0),
             c.get('rollout', {}).get('state', 'idle')))
    # layout/mesh columns: which decode cache layout and mesh each
    # replica ACTUALLY loaded — a rolling rollout to the block-paged tier
    # is auditable mid-flight. pid/artifact: the WORKER-reported identity
    # from hello/heartbeats, so a wedged row maps to a process + artifact
    # dir even when the router-side view is stale
    print('%-8s %-9s %5s %6s %8s %7s %8s %8s %5s %9s %8s %s' %
          ('replica', 'state', 'tier', 'layout', 'mesh', 'pid',
           'backlog', 'requests', 'occ', 'hb-age(s)', 'compiles',
           'artifact'))
    reps = st.get('replicas', {})
    for rid in sorted(reps, key=lambda r: int(r)):
        s = reps[rid]
        hb = beats.get(int(rid), {})
        hb_age = hb.get('age_s', s.get('hb_age_s'))
        # backlog = router pending + worker queue (outstanding would
        # double-count frames already inside the worker's queue)
        backlog = s.get('pending', 0) + s.get('queue_depth', 0)
        artifact = hb.get('artifact') or s.get('artifact') or '-'
        print('%-8s %-9s %5s %6s %8s %7s %8d %8d %5.2f %9s %8s %s' %
              (rid, s.get('state', '?')[:9], s.get('tier', 'bf16'),
               s.get('layout') or '-', s.get('mesh') or '-',
               hb.get('pid') or s.get('pid') or '-',
               backlog, s.get('requests', 0),
               s.get('occupancy', 0.0),
               ('%.2f' % hb_age) if hb_age is not None else '-',
               s.get('compiles') if s.get('compiles') is not None
               else '-',
               os.path.basename(str(artifact).rstrip('/'))
               if artifact != '-' else '-'))
    return 0 if healthy else 1


def cmd_drain(args):
    st, age = _read_status(args.fleet_dir)
    if st is None:
        print('fleet_ctl: no readable status.json under %s'
              % args.fleet_dir, file=sys.stderr)
        return 2
    rid = str(args.replica)
    rep = st.get('replicas', {}).get(rid)
    if rep is None:
        print('fleet_ctl: fleet has no replica %s (replicas: %s)'
              % (rid, sorted(st.get('replicas', {}))), file=sys.stderr)
        return 2
    if rep.get('state') == 'retired':
        print('replica %s already retired' % rid)
        return 0
    if rep.get('state') == 'dead':
        # dead is not a clean drain: its in-flight work failed loudly
        print('fleet_ctl: replica %s is DEAD (crashed/hung), not '
              'drained — in-flight work was lost' % rid,
              file=sys.stderr)
        return 1
    if age > args.stale_s:
        print('fleet_ctl: status.json is %.1fs stale — no live router '
              'to execute the drain' % age, file=sys.stderr)
        return 1
    ctl = os.path.join(args.fleet_dir, 'ctl')
    os.makedirs(ctl, exist_ok=True)
    cmd_path = os.path.join(ctl, 'drain_%s_%d.json' % (rid, os.getpid()))
    tmp = cmd_path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump({'cmd': 'drain', 'replica': int(rid),
                   'time': time.time()}, f)
    os.replace(tmp, cmd_path)
    deadline = time.monotonic() + args.timeout
    while time.monotonic() < deadline:
        st, _age = _read_status(args.fleet_dir)
        state = (st or {}).get('replicas', {}).get(rid, {}).get('state')
        if state == 'retired':
            print('replica %s drained -> retired' % rid)
            return 0
        if state == 'dead':
            # the replica crashed/hung instead of draining: its
            # in-flight work failed loudly — not a clean scale-in
            print('fleet_ctl: replica %s DIED during the drain — '
                  'in-flight work was lost' % rid, file=sys.stderr)
            return 1
        time.sleep(0.25)
    print('fleet_ctl: replica %s did not retire within %.0fs (state %r)'
          % (rid, args.timeout,
             (st or {}).get('replicas', {}).get(rid, {}).get('state')),
          file=sys.stderr)
    return 1


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m paddle_tpu_torch.inference.fleet_ctl',
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest='cmd')
    p = sub.add_parser('status', help='fleet health + per-replica table')
    p.add_argument('fleet_dir')
    p.add_argument('--json', action='store_true')
    p.add_argument('--stale-s', type=float, default=_STALE_S)
    p = sub.add_parser('drain', help='drain + retire one replica')
    p.add_argument('fleet_dir')
    p.add_argument('replica', type=int)
    p.add_argument('--timeout', type=float, default=120.0)
    p.add_argument('--stale-s', type=float, default=_STALE_S)
    args = ap.parse_args(argv)
    if args.cmd == 'status':
        return cmd_status(args)
    if args.cmd == 'drain':
        return cmd_drain(args)
    ap.print_usage(sys.stderr)
    return 2


if __name__ == '__main__':
    sys.exit(main())
