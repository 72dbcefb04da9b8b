"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives armada_tpu_torch's main path, one scheduling round as the
scheduler runs it (build_round_snapshot -> prep_device_round ->
pad_device_round -> solve_round -> validate_round), on the card, and holds
every hand-written CUDA kernel of that path against its plain torch
version. Phases, each printing one JSON line with its seconds. Every
phase after the kernels' is bound by the host, the card idle most of the
time, so after phase 3 two more processes on the same card
(`SidePhases`) run phases 10, 12, 13, 16 and 19, and phases 4, 11, 14, 15
and 18, which need nothing of the others, while this one runs 5 to 7, 9
and 17; phase 8
runs alone once the side processes have ended (its ring kernel spins
across four processes' contexts, and its times would count another
one's work). Launch counts are per process, set to 0 and read within
each run as before. A side's lines are printed when it ends, then one
line of each process's peak reserved device memory.

1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: the nvcc build of armada_tpu_torch/csrc/*.cu and the host C++
   build of csrc/quantity.cpp, the snapshot's quantity parser (one
   compiler per source, started together).
3. kernels: each kernel against its plain version on the card at the main
   path's shapes, all outputs bit-equal. score_nodes at N = 8192 and
   65536 and at a 2x2 shard's shapes, local N = 2048 and 16384 (node gids
   offset to the shard's block, the affinity row and the rank bits of the
   global node count), through the full-argument wrapper and through a
   round-like ScorePlan of 8 jobs (affinity group none, 0 or 1) as the
   fill loop calls it, `plan.score(alloc0, j)`. fill_take at TAKE_SHAPES:
   N = 8192 and 65536 with B = 512 and 2048, N = 2048 and 16384 with B =
   512, with distinct keys, duplicates and a sentinel tail; a B > N case;
   every cluster size (1 CTA at 8192, 2 at 16384, 4 at 32768, 8 at
   65536); ragged slices (4097, 20001); a key view that starts 8 bytes
   into its allocation (a ragged head); N = 262144, beyond the cluster's
   shared memory (streamed); B = 4096 and 8192 at N = 65536, past the
   survivors' shared-memory budget (sorted in global memory); and
   score_nodes' masked keys at N = 65536 and on the shards. segment_add
   (the "cuda" path's integer scatter-adds) at SEGMENT_CASES
   (tools/solve_ab.py: the round's sums, the class and queue sums with
   sorted indices, every row into one segment, the flagship's rows into
   its nodes), int32 and int64, values at the types' extremes (the sums
   wrap), half of them 0, under every strategy of `segment_plan` that
   accepts the case, into zeros or onto x as the round calls it and onto
   a seeded x; a profiler check of one call per case (one segment kernel,
   plus the plan's memset or copy; no clone, no zero fill); torch's
   index_add without the deterministic switch timed in a child process
   (`chip_smoke.py --segment-library`, run after the build).
4. round: 100,000 queued jobs x 5,000 nodes x 10 queues plus 5,000 running
   preemptible jobs in one queue, in the default configuration (batch
   fill window 512, fast fill off), on the "cuda" and the "lax" kernel
   paths: every output array, num_loops and spot_price bit-equal; the
   round firewall admits it; both kernels launched.
5. flagship: 1,000,000 jobs x 50,000 nodes x 10 queues plus the same
   running jobs, on the "cuda" path: admitted, both kernels launched.
6. fast_fill: fast fill (the merged multi-queue window fill and the
   evicted-rebind window), each run admitted with both fill kernels
   launched and merged loops on every path: round_100k at a window of 512
   on "cuda" and "lax" (bit-equal); the flagship in the bench's
   configuration (window 2,048; phase 5's padded round refilled); the
   home/away round of parallel/scenarios.py at 16,384 nodes x 65,536 jobs
   on "cuda" and "lax" (bit-equal) and on a 2x2 mesh of shard threads
   (held to the single device; winner_reduce launched); and a window of
   4,096 on 5,000 nodes, where fill_take sorts its 4,096 survivors in
   global memory (its `fill_take_global_sort` count above 0 in that run;
   "cuda" equal to "lax"). Prints loops and host seconds
   by kind, scheduled and preempted counts.
6b. driver: the host-driven driver as the scheduler asks for it (round
   budget, rescue pass, hot window), each run admitted by the round
   firewall with score_nodes and fill_take launched on "cuda":
   flagship_window, phase 5's flagship at the scheduler's default hot
   window (window=4096, the default min-slots floor), compacted and
   bit-equal to phase 5's fused output with the same loops by kind, its
   solve seconds beside the fused ones with gather_s and rewindows;
   flagship_fast_window, phase 6's flagship_fast at the same window,
   compacted and bit-equal to its fused output; round_25k (phase 7's
   eviction round, solved here first) at budget_s=1e-6 on "cuda" and
   "lax", truncated, the paths bit-equal, its placements and preemptions
   subsets of the full round's; flagship_budget, flagship_window at
   budget_s=5.0 (Armada's maxSchedulingDuration), a prefix of
   flagship_window; home_away_window, the home/away round at 4,096 nodes
   x 16,384 jobs at window=64 and window_min_slots=0, compacted with at
   least one rewindow and bit-equal to its fused solve.
7. sharded: the node-sharded round on a 2x2 (hosts, chips) mesh, four
   shard threads on cuda:k % card count, through
   `resolve_solver("2x2", "cuda", devices=...)` (the chip and the host
   stage of every node selection closed by the winner kernel: in
   gangs_100k, 2 x selects x 4 shards launches, required). Each run is
   held to the single-device "cuda" output of the same round on every
   array, num_loops and spot_price included, and admitted by the round
   firewall:
   - round_25k, round_100k at a quarter of its shape (25,000 jobs x
     1,250 nodes x 1,250 running jobs), solved on one device first: its
     serial loops return evicted jobs to their own nodes, so it selects no
     node (score_nodes and fill_take launched). A quarter of the shape
     quarters the serial loops, which cost most of the phase on four shard
     threads;
   - gangs_100k: 100,000 queued jobs x 5,000 nodes, every 8th job opening
     a gang of 2, 4 or 8, no running jobs, solved on one device on the
     "cuda" and "lax" paths (bit-equal, so the sharded run is held to a
     path that runs none of the kernels) and then sharded (the gangs select
     nodes: all three kernels launched);
   - phase 6's flagship_fast at full node width (N split 4 x 16,384; the
     top-B merge at B = 2,048; fill kernels launched). Not phase 5's
     fused flagship: its 995 single-queue fills (about 52 s in threads)
     are bound by the burst at about one job a loop, whatever the job
     count, and round_25k and gangs_100k run that fill on the mesh.
   Prints each run's seconds, the shard-to-device map and the
   CollectiveStats.

8. multiproc: phase 7's gangs_100k on a 2x2 grid of four worker
   processes, one per shard, all on the card (cuda:k % card count) over
   gloo, through `parallel.launcher.launch` on the padded round saved to
   a temporary .npz: rank 0's outputs bit-equal to the single-device
   "cuda" solve and admitted by the round firewall, every rank's equal,
   score_nodes, fill_take and winner_reduce launched (summed over the
   ranks; winner_reduce 2 x selects x 4 shards times), CollectiveStats
   equal to phase 7's in-process 2x2 run. The
   round does not call the ring kernel (nor does the reference's), so the
   same workers then drive it over the host and the chip axis (n = 2
   each), and a second, ring-only launch on a 1x4 grid over its chip axis
   (n = 4): per axis, 100 calls for each K in {1, 3, 5} and found share
   0, 1/2 and 1 with fresh seeded rows (not-found rows tie), each call's
   result equal to the plain version's row on that member; then `ms` per
   call (CUDA events), the profiler's device ms, the plain version's ms
   and that of a gather plus winner_reduce on the same rows.
   Prints the backend, the rank-to-device map, each rank's solve seconds
   and each launch's seconds.
9. policies: the fairness policies, each run's round an earlier phase's
   prepared round with its policy fields replaced (`workload.repolicy`:
   queue weights 1 to 10 in name order; for deadline, queue q's deadline
   3,600 q s after the first and every third queue without one; equal to
   a fresh prep, tests/test_torch_policy.py): flagship_fast and
   round_100k_fast (phase 6) under proportional, priority and deadline,
   and the fused flagship (phase 5) under priority, "cuda" bit-equal to
   "lax" with score_nodes and fill_take launched; flagship_fast under
   priority on a 2x2 mesh of shard threads, held to its single device.
   Prints loops by kind beside the DRF round's, solve seconds and
   launches.
10. market: market_round(128, 8192) (market_scarce: the spot price set,
   jobs preempted) and market_round(2048, 8192) (market_fleet, the market
   round of mixed_fleet_rounds(16384, 65536)), each on one device on
   "cuda" with only segment_add launched (a market round takes no fill
   and selects no node on one device), then market_scarce on a
   2x2 mesh of shard threads held to the single device, with 2 x selects
   x 4 shards winner_reduce launches (market_fleet's 2x2 run was cut
   for the time limit).
11. warm: the warm scheduling cycle as bench.py runs it
   (`workload.WarmCycle`: an IncrementalRound takes last round's leases
   and as many fresh submits, a ResidentRound delta-syncs the padded round
   into persistent buffers on the card, `solve_round` solves it host-driven
   at hot window 2 x the fill window with no floor, and the round
   firewall checks it on the host mirror). The flagship in bench.py's
   configuration: the reset upload and cold solve, one settling cycle,
   then WARM_CYCLES measured cycles, each a "delta" sync below the
   reset's bytes, a solve booking no upload that launches score_nodes and
   fill_take, no drift after it, and outputs bit-equal to a solve of a
   fresh upload (outside the timed part); the last resident tree on
   "lax" equal to "cuda". Prints the median cycle_s with min, max and
   quartiles, the median cycle's delta_s, h2d_s (the sync; its first
   part snapshot_s, and prep_pad_s, the same generation's prep and pad
   timed again after the cycle), solve_s and validate_s, the reset's and
   the deltas' bytes up and their ratio, and
   the last round's Jain index and max regret. Then at round_25k's shape:
   a burst past the padded capacity resets into regrown buffers (still
   bit-equal, the next cycle a delta), and a field corrupted on the card
   is the one check_drift names, with a clean reset after reset().
12. service: the scheduler service (services/scheduler.py) fed through
   the control plane (`workload.submit_events`, `workload.ServiceRun`):
   service_100k, round_100k's 100,000 queued jobs in 10 queues submitted
   through the SubmitService, two fake executors of 2,500 nodes of 32
   cpu / 256Gi in one pool, the bench's config (fast fill, window 2,048,
   default rate limits), one service on "cuda" and one on "lax" fed the
   same events, 1 cold and 4 warm cycles each, the executors ticking
   before each cycle: equal leases and preemptions cycle by cycle; a
   ladder of the configured kernel path alone (no "lax" or host rung
   below it on the card); every round on it with no failover and no
   firewall rejection; "resident" rounds with "delta" syncs from the second cycle;
   no drift after the last; both fill kernels launched by the "cuda"
   service (counts set to 0 before it, read after) and none by "lax".
   service_flagship, the flagship's 1,000,000 queued jobs on 50,000
   nodes, one "cuda" service, 1 cold and 1 warm cycle, the same checks.
   sim_differential, the JAX package's differential simulation
   (`workload.sim_workload`, seed 0) through the port's Simulator on the
   card: the kernel history equal to the oracle's, no failover, both
   fill kernels launched; then one `solver_raise` injected on local:cuda
   (services/chaos.SolverChaos), the one rung of the card's ladder: the
   round is rejected with its cause recorded, its work leases a cycle
   later on local:cuda, and the history is that of an oracle run with
   the same fault on its one rung. Prints per cycle the jobs leased
   and preempted, snapshot, sync, solve and cycle seconds, the sync mode
   and bytes, the round's compile delta (no kernel library built or
   loaded in a warm cycle), and per run the submit and ingest
   microseconds a job.
13. observatory: the round observatory and the market pool's post-round
   seams (`phase_observatory`). fixture_replay, the committed bundle the
   JAX package recorded (tests/fixtures/sim_steady.atrace) replayed by
   the port under LOCAL ("cuda"), "lax" and hotwindow:64 (compacted, on
   "cuda"), one replay each: zero divergences, both fill kernels launched
   by LOCAL and by hotwindow:64, none by "lax". recorded_service,
   service_100k's "cuda" service with a TraceRecorder, the metrics and
   an SLOTracker attached, 1 cold and 2 warm cycles: every round in the
   bundle, no kernel library built or loaded in a warm cycle, the bundle
   replayed under LOCAL and "lax" with zero divergences and no build;
   bytes and recording seconds a round, alloc_segments a cycle, the SLO
   burn rates. market_service, `workload.MarketServiceRun` at
   market_round(128, 8192) on the card ("cuda") and on the host oracle,
   fed the same events (the optimiser on, two gang shapes priced, band
   B's bid raised after the second fetch), 1 cold and 2 warm cycles:
   equal leases, preemptions, spot prices, indicative prices (none timed
   out), idealised and realised values, and the third cycle's refresh
   re-prices jobs. A market round's window is 0, so the card's service
   launches no fill kernel. postmortem, phase 12's
   faulted kernel simulation with a recorder: the rejected round's
   postmortem bundle replays on "cuda" with zero divergences and its
   replayed solve passes the round firewall.
14. autotune_whatif: autotune and the what-if planner beside the live
   round (`phase_autotune_whatif`), at service_100k's width in the
   bench's config with the hot window at 2,048 slots and no floor
   (compacted at 131,072 rows). autotune_offline, a service's 1 cold
   and 2 warm cycles recorded, `tune_corpus` over them at the baseline
   and windows 1,024, 4,096 and 16,384 on "cuda" (every candidate
   bit-exact and launching
   both fill kernels and segment_add), the selected entry through a
   TuningStore and a CheckpointStore. autotune_online, a second service
   seeded from a reloaded store at window 1,024 (the grid's narrowest,
   which compacts, kept apart from the timed selection) with an
   AutotuneController: every recorded round autotuned at that window and
   compacted, its leases the untuned service's every cycle. whatif_plan, a WhatIfService on the untuned service:
   a drain plan of one executor, an injected gang of 8, and parity of
   the committed fixture fork under LOCAL (zero divergences), the
   rollouts launching both fill kernels; the drain then run live equal
   to the plan. whatif_isolation, six plans fired at a 1-worker,
   2-deep planner while three live cycles run: some shed, the rest
   done, the live leases those of the twin service with no planner,
   no kernel library built or loaded in a live cycle.
15. persistence: the file-backed event log, the soak tools, the front
   door and the what-if planner's rollout processes on the card
   (`phase_persistence`), every service at service_100k's width in the
   bench's config with a 5 s round budget (Armada's
   maxSchedulingDuration) and held to an uninterrupted in-memory twin's
   leases cycle by cycle. file_log_service, over a FileEventLog: 3
   cycles, a restart (a new log on the directory, a new service whose
   job database is rebuilt from it), 2 more. soak, chaos_soak's
   run_plan(0, "kernel", 24) (torn tails on the real file log) and
   run_solver_plan(0, 24), each twice: equal digests, every job
   finished, every solver fault contained. frontdoor_service, the jobs
   through a 3-shard front door, pumped, then 2 cycles. whatif_isolation,
   a budgeted service with a 2-worker planner: 2 waves of 2 inject-gang
   plans of 100k-job rollouts in rollout processes on the card while it
   and the twin cycle in step, its leases the twin's every cycle, no
   round cut by its budget, the median live cycle beside the rollouts
   at most 1.5x the median alone, the second wave's plans sending under
   a tenth of the fork's specs (the processes hold them); each live
   cycle's seconds alone and beside the rollouts, the slowest against
   the budget, and what each plan cost the live process.
16. lookout: Lookout and the query side beside a kernel service on the
   card (`phase_lookout`), after phase 13 in its process. A service at
   service_100k's width in the bench's config on local:cuda, recording
   its rounds and spans; an in-memory and a SQLite Lookout store and the
   event-stream index follow its log on a BackgroundTaskManager's sync
   loops; a LookoutHttpServer serves the query API over the in-memory
   store with binoculars. 1 cold and 4 warm cycles with a thread sending
   requests beside each, then 3 warm cycles alone (loops stopped). After
   each cycle, the stores at the log's end: the SQLite rows the
   in-memory rows; per-queue counts by state the job database's; the
   index's streams a scan of the log; the bodies of /api/jobs (queue
   filter, ordered, paged), /api/groups (by queue, state counts),
   /api/details, /api/jobtrace and /api/logs of a leased job,
   /api/fairshare, /api/fairness, /api/report and /api/doctor equal to
   the direct calls. A POST /api/cancel and /api/reprioritize after the
   third cycle (the heads of two served queues) show in the next
   cycle's leases and rows. The port's fairness_report over the bundle
   names every queue; trace2perfetto over the bundle and the span file
   holds every round. Prints the stores' first and later syncs, the
   SQLite file's bytes, the requests' latencies, and the median live
   cycle against the median alone with their ratio (not gated).
17. wire: the wire and the executor side (`phase_wire`), after phase 9
   in this process. Two stacks wired as the JAX package's ControlPlane
   wires its parts, minus the gRPC listener (`WireStack`: in-memory log,
   SchedulerService on the card, kernel path "cuda" in one and "lax" in
   the other, SubmitService, QueryApi, EventStreamIndex,
   BinocularsService, ApiServer), each with a RestGateway behind a
   ChaosProxy and two ExecutorAgents of 2,500 nodes leasing through the
   method table over the JSON codec (`Loopback`, the JSON wire minus its
   socket). service_100k's 100,000 jobs go in as JSON job dicts by REST
   through the proxies in requests of 1,000, one inside a partition
   window (it fails; sent again after the heal it lands once). 1 cold
   and 4 warm cycles as ControlPlane._loop runs them: the stacks'
   leases equal every cycle, the fill kernels launched on local:cuda,
   every leased run a pod on its agent and each pod's phase its job's
   state, the REST and loopback reads equal to their direct calls; a
   CancelJobs and a ReprioritizeJobs through the loopback before the
   last cycle show there and in the next exchange; the agents' final
   ExecutorSyncs are clean. Prints the REST submit rate and latencies,
   each agent's exchange seconds and lease reply bytes a cycle, the
   cycle seconds (beside phase 12's service_100k after the side
   processes end) and the loopback calls' latencies. The partition
   check reads the proxies' severed counts before the window opens and
   after it has closed and the listeners are back.
18. clients: the clients, the CLIs and the testsuite (`phase_clients`),
   last in the side process of phases 4, 11, 14 and 15. Stacks wired as
   ControlPlane wires its parts, minus the gRPC listener (`ClientStack`:
   FakeExecutors, an SLOTracker and a WhatIfService beside phase 17's
   parts), reached through `LoopbackClient`, ApiClient's methods over
   the method table and the JSON codec. (a) tests/test_testsuite.py's
   plane (6 nodes of 16 cpu, 64Gi and 4 GPUs in zone z1, three priority
   classes, jobs running 3 s) on the "cuda" path, cycling every 0.05 s
   on the wall clock in a thread: the nine testsuite_cases specs
   (TESTSUITE_SPECS, held equal to the files by a CPU test) pass through
   the port's TestSuiteRunner, the preemption spec preempting, and a
   spec no node fits times out. (b) Two stacks, "cuda" and "lax", with
   two executors of 2,500 nodes of 32 cpu / 256Gi: the port's load
   tester submits 100,000 jobs of 2 cpu / 4Gi in batches of 1,000 over
   nine queues to each; two cycles, leases equal once the jobs are
   matched by their place in the job database's order; armadactl's
   `main` on both (queue create, get and list, jobs --queue, report,
   fairness and its JSON, doctor, slo, job-trace, whatif --inject-gang,
   drain --dry-run, cancel, reprioritize, node and executor cordon),
   every output equal once ids, submit times, plans' solver labels and
   round durations are mapped (`_Canon`); the next cycle shows the
   cancel, the reprioritise and both cordons (every lease on
   executor-1, none on the cordoned node). Then broadside's in-process
   and SQLite backends for 3 s each over 100,000 seeded rows, no error
   on any operation. Fill kernels launched in part (a) and in every
   "cuda" cycle, none in a "lax" one. Prints per spec its seconds, the
   load tester's reports, per cycle its seconds and leases, per command
   and stack its seconds, output rows and reply bytes, and broadside's
   reports.
19. conformance: placement conformance (`phase_conformance`), last in the
   side process of phases 10, 12, 13 and 16. The reference's test files
   are compiled for the port from the checkout's tests/ (their
   `armada_tpu` imports pointed at the port and tests/test_kernel_parity.py's
   assert_parity at tests/torch_conformance.py's twin; no JAX). (a)
   tests/test_reference_tables.py's 27 Go table cases (from Go's
   preempting_queue_scheduler_test.go, each round's scheduled and
   preempted sets as Go expects them) and tests/test_parity_scale.py's
   sweep, 128 and 256 nodes and its 1,000-node x 2,000-job case: every
   round solved on "cuda" and on "lax", bit-equal on every output, the
   first against the port's host oracle under the reference's checks
   (assigned node, scheduled and preempted masks equal, capped fair
   shares within a relative 1e-12). (b) tests/test_baseline_configs.py's
   five configurations (BASELINE.md's: 1,000 jobs on 100 nodes, 10
   weighted queues, 128-way gangs, preemption across priority classes,
   10 clusters with taints and a floating resource) through the port's
   Simulator on the kernel backend on the card and on the oracle
   backend: each case's own assertions hold on both and the leases after
   every scheduling cycle are equal. (c) the port's quantity parser
   (csrc/quantity.cpp, built by the build phase on this host) against
   the Fraction path on tests/test_native.py's samples at every scale
   and rounding, 20,000 seeded fuzz values and the request dicts of a
   1,000,000-job `workload.build_inputs` build (its distinct specs on
   both paths, the Fraction path being `from_map`, and the whole batch
   by the parser, each row the Fraction path's for its spec; both
   roundings). Fill kernels launched in (a) and in
   (b)'s kernel runs, none in an oracle run. Prints per case its
   seconds, rounds, jobs and decisions and the seconds of the snapshot,
   the oracle, the prep and each path's solve; per configuration and
   backend its seconds, cycles and launches; the parser's checks and
   seconds (both paths per fuzz value and on the distinct specs, the
   parser on the batch). Nothing of the JAX package is imported:
   tests/test_torch_conformance_phase.py runs the phase with jax and
   armada_tpu blocked.

Phase 3 also holds winner_reduce against its plain version at P in {1, 2,
3, 8, 32, 33, 1024} and K in {1, 2, 3, 4, 5} (duplicate-heavy leading keys, a
permutation as the last key; some found, none found), on P rows as the
sharded select gathers them and on the reference's rows padded to a power
of two: the row, and the select's gid and found, equal; and times a
one-element torch add on the device, the launch floor.

Then one {"kernels": [...]} line (`launches` from the sharded gangs_100k,
the run where the round's three kernels must launch, and for the ring
kernel from phase 8's ring drive; the other sharded runs', the
single-device counts, phase 6's (`launches_fast_fill_flagship`, `launches_round_100k_fast`,
`launches_home_away_2x2`), the driver phase's (`launches_flagship_window`
and the rest), the policy runs' summed (`launches_policy_runs`,
`launches_flagship_fast_priority_2x2`) and the market runs'
(`launches_market_single_device`, 0 for every kernel but segment_add, and
`launches_market_2x2`) and the warm cycles' summed
(`launches_warm_cycles`, phase 11's measured cycles) and phase 12's
(`launches_service_100k`, the "cuda" service's five cycles;
`launches_service_flagship`; `launches_sim_kernel`, the clean kernel
simulation), phase 13's summed (`launches_observatory`), phase 14's
summed (`launches_autotune_whatif`, its rollouts' counted in their
process), phase 15's (`launches_persistence`, likewise), phase 16's
(`launches_lookout`), phase 17's (`launches_wire`, the "cuda" stack's
five cycles), phase 18's (`launches_clients`, the testsuite plane's
cycles and the "cuda" stack's three) and phase 19's
(`launches_conformance`, the "cuda" rounds of part (a) and the kernel
simulations of part (b)) beside them;
times
at the flagship's shapes,
winner_reduce's at the round's P = 2, K = 3 (the host stage's call, gid
and found included) and the ring's at n = 4, K = 3 (and at n = 2,
`ms_n2`): `ms` per call from CUDA events, `device_ms` per launch from the
profiler, and for these two `floor_device_ms`, the launch floor;
fill_take's also at N = 8192 (`ms_at_8192`, with torch.sort's time there)
and its cluster size, score_nodes' also through the plan,
`plan_ms` and `plan_device_ms`; fill_take's also at B = 4,096,
`ms_at_b4096` and the rest; segment_add's at 131,072 job rows of 4
int64 lanes into 8,192 nodes (`device_ms` a whole call, the plan's memset
included, and `bound_share` against it; the kernel's own launch
`kernel_device_ms`), and per SEGMENT_CASES case in `cases`:
the strategy, ms, device ms a call, bound, plain and library ms, each
accepted strategy's times in `by`), one line of ptxas's registers and
shared memory for fill_take_kernel's two instantiations, the global
sort's sort_runs_kernel and merge_kernel, winner_reduce_kernel and the
segment kernels (the most of their instantiations)
(`nvcc -Xptxas -v`), the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Any failure exits non-zero before the last line.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
SCALAR_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
# The kernels every "cuda" round with a fill launches, and those of a
# round on a mesh that selects nodes; the ring kernel is driven in phase 8.
FILL_KERNELS = ("score_nodes", "fill_take", "segment_add")
ROUND_KERNELS = FILL_KERNELS + ("winner_reduce",)
RING_CALLS = 100  # per axis, K and found share
WINNER_ROWS = (1, 2, 3, 8, 32, 33, 1024)  # P held on the card, at K = 1, 3, 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def device_ms(fn, iters, kernel):
    """Mean device milliseconds per launch of the CUDA kernel whose name
    contains `kernel`, from torch.profiler over `iters` calls of fn()."""
    return device_ms_many({kernel: fn}, iters, kernel)[kernel]


def score_case(n, seed, shards=1):
    """Inputs of score_nodes at N nodes (bench widths: R = 4, one taint and
    one label word, 8 excluded-node slots, an affinity row), on the card.
    With shards > 1, the inputs of the last of `shards` equal node blocks
    as a shard of the node-sharded round sees them: node gids offset to
    the block, ranks a slice of a permutation of the global node count,
    the affinity row over the global width, the rank bits of the global
    node count."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    r = 4
    n_global = n * shards
    offset = n_global - n
    dev = torch.device("cuda")

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    total = np.tile(np.array([32000, 262144, 0, 0], np.int32), (n, 1))
    alloc0 = total - rng.integers(-4000, 33000, size=(n, r)).astype(np.int32)
    alloc0[:, 2:] = 0
    words = lambda k: rng.integers(-(2**31), 2**31, size=k, dtype=np.int64).astype(np.int32)  # noqa: E731
    args = dict(
        alloc0=t(alloc0),
        node_total=t(total),
        taints=t(np.where(rng.random((n, 1)) < 0.2, words((n, 1)), 0).astype(np.int32)),
        labels=t(words((n, 1))),
        rank=t(rng.permutation(n_global)[offset:].astype(np.int32)),
        gid=t(np.arange(offset, n_global, dtype=np.int32)),
        unsched=t(rng.random(n) < 0.05),
        aff_row=t(words((n_global + 31) // 32)),
        tolerated=t(words(1)),
        selector=t((words(1) & 0x0101).astype(np.int32)),
        req_fit=t(np.array([2000, 4096, 0, 0], np.int32)),
        # two excluded nodes in this block, one outside it
        excl=t(np.array([offset + 3, offset + 17, 5 if offset else -1, -1, -1, -1, -1, -1],
                        np.int32)),
        order_res_idx=t(np.array([0, 1], np.int32)),
        order_res_resolution=t(np.array([1, 1], np.int32)),
    )
    rank_bits = max(1, (n_global - 1).bit_length())
    bits = (16, 19, rank_bits)
    if sum(bits) > 62:
        bits = (15, 16, rank_bits)
    args["bits"] = t(np.array(bits, np.int32))
    args["batch_window"] = 512
    args["job_ok"] = True
    return args


def score_bytes(a):
    n, r = a["alloc0"].shape
    read = sum(
        v.numel() * v.element_size() for v in a.values() if hasattr(v, "numel")
    )
    return read + n * (1 + 4 + 8), n * (10 * r + 40)


def take_case(n, b, seed, kind):
    """Packed-key inputs of fill_take: distinct keys, duplicates, or a
    sentinel tail (fewer than B real keys)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sentinel = np.iinfo(np.int64).max
    if kind == "dups":
        key = rng.integers(0, max(2, n // 64), size=n).astype(np.int64) << 20
    else:
        key = rng.integers(0, 2**60, size=n, dtype=np.int64)
    if kind == "tail":
        key[rng.permutation(n)[: n - b // 3]] = sentinel
    else:
        key[rng.random(n) < 0.3] = sentinel
    return torch.as_tensor(key, device="cuda"), b


def check_equal(name, got, want, **case):
    """Hold a kernel's outputs to its plain version's; returns the check's
    record, or raises when they differ."""
    import torch

    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in zip(got, want))
    equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    if not equal:
        raise AssertionError(f"{name} disagrees with its plain version at {case}")
    return {"name": name, **case, "equal": equal, "max_abs_err": err}


def plan_case(a, n_jobs=8):
    """A round-like ScorePlan over score_case's nodes: n_jobs jobs whose
    rows are the case's job with its request scaled per job, the case's
    affinity row and a second one as the affinity table (job j in group
    j % 3 - 1: none, 0 or 1), every job possible."""
    import torch

    from armada_tpu_torch.ops import kernels as kt

    dev = a["alloc0"].device
    jobs = torch.arange(1, n_jobs + 1, dtype=torch.int32, device=dev)
    plan = kt.ScorePlan(
        a["node_total"], a["taints"], a["labels"], a["rank"], a["gid"], a["unsched"],
        a["tolerated"].repeat(n_jobs, 1), a["selector"].repeat(n_jobs, 1),
        (a["req_fit"][None, :] * jobs[:, None] // 2).contiguous(),
        a["excl"].repeat(n_jobs, 1), ((jobs - 1) % 3 - 1).to(torch.int32),
        torch.ones(n_jobs, dtype=torch.bool, device=dev),
        torch.stack([a["aff_row"], a["aff_row"].roll(1)]).contiguous(),
        a["order_res_idx"], a["order_res_resolution"], a["bits"], a["batch_window"],
    )
    return plan


def plan_args(a, plan, j):
    """score_nodes' arguments for job j of a plan_case plan."""
    g = int(plan.aff_group[j])
    return {**a, "req_fit": plan.req_fit[j], "aff_row": plan.affinity[g] if g >= 0 else None}


def time_fill_take(key, b, checks):
    """fill_take's times at one shape: the wrapper (CUDA events), the
    kernel on the device (profiler), its plain version, torch.sort."""
    import torch

    from armada_tpu_torch.ops import kernels as kt
    from armada_tpu_torch.timing import cuda_ms

    n = key.shape[0]
    want = min(b, n)
    extra = {}
    if kt.fill_take_config(n, want).global_sort:
        # The global sort's two kernels, one launch of each per call while
        # want <= 2 x FILL_TAKE_MAX (one merge level).
        assert want <= 2 * kt.FILL_TAKE_MAX
        extra["sort_device_ms"] = sum(
            device_ms(lambda: kt.fill_take(key, b), 50, k) for k in ("sort_runs_kernel", "merge_kernel")
        )
    return {
        **extra,
        "ms": cuda_ms(lambda: kt.fill_take(key, b), 200),
        # The select kernel; past FILL_TAKE_MAX the sort's two kernels add
        # to it (`ms` is the whole call).
        "device_ms": device_ms(lambda: kt.fill_take(key, b), 50, "fill_take_kernel"),
        "plain_ms": cuda_ms(lambda: kt.fill_take_plain(key, b), 50),
        "bound_ms": (n * 8 + want * 12) / HBM_BYTES_PER_S * 1e3,
        "library_ms": cuda_ms(lambda: torch.sort(key, stable=True), 50),
        "max_abs_err": checks[-1]["max_abs_err"],
        "cluster": kt.fill_take_config(n, want).cluster,
        "shape": {"N": n, "B": b},
    }


# fill_take's shapes on the card: the single-device rounds' N (8,192 and
# 65,536) and a 2x2 shard's (2,048, 16,384), B = 512 and 2,048, with
# duplicate keys and a sentinel tail; B > N; every cluster size (N = 8,192:
# 1 CTA, 16,384: 2, 32,768: 4, 65,536: 8); ragged slices (4,097: an odd
# slice, 20,001: four CTAs of unequal length); a key view 8 bytes past an
# allocation (a ragged head); and N = 262,144, beyond the cluster's shared
# memory (streamed); B = 4,096 and 8,192 at N = 65,536, past the survivors'
# shared-memory budget (the global sort).
TAKE_SHAPES = (
    [(n, b, kind) for n in (8192, 65536) for b in (512, 2048) for kind in ("distinct", "dups", "tail")]
    + [(65536, b, kind) for b in (4096, 8192) for kind in ("distinct", "dups", "tail")]
    + [(n, 512, kind) for n in (2048, 16384) for kind in ("distinct", "dups", "tail")]
    + [(300, 512, "distinct")]
    + [(n, b, kind) for n in (4097, 20001, 32768, 262144) for b in (512, 2048) for kind in ("distinct", "dups", "tail")]
)


def phase_kernels():
    """score_nodes and fill_take against their plain versions at the
    single-device round's node counts (N = 8192, 65536) and at a 2x2 shard's
    (local N = 2048, 16384 of the same global counts), score_nodes also
    through a round-like plan; fill_take at every TAKE_SHAPES case. Timing
    at N = 65536 (fill_take also at 8192)."""
    import torch

    from armada_tpu_torch.ops import kernels as kt
    from armada_tpu_torch.timing import cuda_ms

    checks = []
    timing = {}
    sentinel = torch.iinfo(torch.int64).max
    for n, shards in ((8192, 1), (65536, 1), (2048, 4), (16384, 4)):
        a = score_case(n, n + shards, shards)
        got = kt.score_nodes(**a)
        checks.append(check_equal("score_nodes", got, kt.score_nodes_plain(**a), n=n, shards=shards))
        plan = plan_case(a)
        for j in range(plan.jobs):
            checks.append(check_equal(
                "score_nodes", plan.score(a["alloc0"], j), kt.score_nodes_plain(**plan_args(a, plan, j)),
                n=n, shards=shards, plan_job=j, aff_group=int(plan.aff_group[j]),
            ))
        if shards > 1:
            # The shard's masked fill key, as fill_sort_path hands it over.
            key = torch.where(got[0], got[2], sentinel)
            checks.append(check_equal("fill_take", kt.fill_take(key, 512), kt.fill_take_plain(key, 512),
                                      n=n, b=512, shards=shards, keys="score_nodes"))
        if (n, shards) == (65536, 1):
            kb, ops = score_bytes(a)
            alloc0 = a["alloc0"]
            times = device_ms_many(
                {"full": lambda: kt.score_nodes(**a), "plan": lambda: plan.score(alloc0, 3)},
                50, "score_nodes_kernel",
            )
            timing["score_nodes"] = {
                "ms": cuda_ms(lambda: kt.score_nodes(**a), 200),
                "device_ms": times["full"],
                "plan_ms": cuda_ms(lambda: plan.score(alloc0, 3), 500),
                "plan_device_ms": times["plan"],
                "plain_ms": cuda_ms(lambda: kt.score_nodes_plain(**a), 20),
                "bound_ms": max(kb / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S) * 1e3,
                "library_ms": None,
                "max_abs_err": max(c["max_abs_err"] for c in checks if c["name"] == "score_nodes"),
                "shape": {"N": n, "R": 4},
            }
    for n, b, kind in TAKE_SHAPES:
        key, b = take_case(n, b, n + b, kind)
        checks.append(check_equal("fill_take", kt.fill_take(key, b), kt.fill_take_plain(key, b),
                                  n=n, b=b, keys=kind, cluster=kt.fill_take_config(n, min(n, b)).cluster,
                                  resident=kt.fill_take_config(n, min(n, b)).resident))
        if (n, b, kind) == (8192, 512, "distinct"):
            at_8192 = time_fill_take(key, b, checks)
        if (n, b, kind) == (65536, 4096, "distinct"):
            at_b4096 = time_fill_take(key, b, checks)
        if (n, b, kind) == (65536, 512, "distinct"):
            timing["fill_take"] = time_fill_take(key, b, checks)
            # The same keys 8 bytes into a larger allocation: a ragged head.
            base = torch.cat([key[:1], key])
            view = base[1:]
            checks.append(check_equal("fill_take", kt.fill_take(view, b), kt.fill_take_plain(view, b),
                                      n=n, b=b, keys=kind, offset_bytes=8))
    # The flagship's own fill keys: score_nodes' masked key at N = 65,536.
    a = score_case(65536, 11)
    fit0, _, key = kt.score_nodes(**a)
    masked = torch.where(fit0, key, sentinel)
    checks.append(check_equal("fill_take", kt.fill_take(masked, 512), kt.fill_take_plain(masked, 512),
                              n=65536, b=512, keys="score_nodes"))
    ft = timing["fill_take"]
    ft["ms_at_8192"] = at_8192["ms"]
    ft["at_8192"] = at_8192
    ft["at_b4096"] = at_b4096
    ft["ms_score_keys"] = cuda_ms(lambda: kt.fill_take(masked, 512), 200)
    ft["max_abs_err"] = max(c["max_abs_err"] for c in checks if c["name"] == "fill_take")
    return checks, timing


# segment_add's cases are SEGMENT_CASES (armada_tpu_torch/tools/solve_ab.py,
# which times the same cases on two trees): the round's integer sums, the
# contention cases (class and queue sums with sorted indices, every row
# into one segment) and the flagship's rows into its nodes.
SEGMENT_TIMED = "rows_to_nodes"
# Host ops that would mean a copy or a zero fill on the kernel path.
SEGMENT_FORBIDDEN = ("aten::clone", "aten::zeros", "aten::zero_", "aten::fill_", "aten::copy_")


def segment_library():
    """`chip_smoke.py --segment-library`, a child process: torch's
    index_add at every segment case, in a process that never turns on the
    deterministic switch, so that it takes torch's atomic path (the same
    integer function, in one call: a case that sums into zeros adds onto a
    zero tensor). Prints {"segment_library_ms": {case_dtype: ms}}."""
    import torch

    from armada_tpu_torch.timing import cuda_ms
    from armada_tpu_torch.tools.solve_ab import SEGMENT_CASES, segment_inputs

    if not torch.cuda.is_available():
        print("chip_smoke --segment-library: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    out = {}
    for i, name in enumerate(SEGMENT_CASES):
        for dtype in (torch.int32, torch.int64):
            x, dim, index, values = segment_inputs(name, dtype, i)
            out[f"{name}_{str(dtype)[6:]}"] = cuda_ms(lambda: x.index_add(dim, index, values), 200)
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("the library timing ran under the deterministic switch")
    emit({"segment_library_ms": out})
    return 0


def segment_library_start():
    """Start the library timing in a child process."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--segment-library"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE)


def segment_library_finish(proc):
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"segment library timing failed ({proc.returncode}):\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])["segment_library_ms"]


def segment_profile(fn, plan):
    """One call of fn() under torch.profiler: the device operations it ran
    and the host ops it called. Holds it to one segment kernel, plus the
    plan's memset or copy when it has one, and no clone or zero fill."""
    import torch

    act = torch.profiler.ProfilerActivity
    for _ in range(PROFILE_TRIES):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        host = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
        kernels = [d for d in device if "segment_" in d]
        if kernels:  # the profiler saw the session's device events
            break
    else:
        raise AssertionError(f"the profiler saw no segment kernel in {PROFILE_TRIES} sessions")
    others = [d for d in device if "segment_" not in d]
    forbidden = sorted({h for h in host if h in SEGMENT_FORBIDDEN})
    if len(kernels) != 1 or len(others) != int(plan.init) or forbidden:
        raise AssertionError(f"segment sum by {plan}: device ops {device}, host ops {forbidden}")
    return {"kernels": len(kernels), "memsets": sum("Memset" in d for d in others),
            "copies": sum("Memcpy" in d for d in others)}


def segment_device_ms(fn, iters):
    """solve_ab.device_total_ms (every device op of a call), measured again
    when the profiler dropped the session's events, up to PROFILE_TRIES
    sessions."""
    from armada_tpu_torch.tools.solve_ab import device_total_ms

    for _ in range(PROFILE_TRIES):
        ms = device_total_ms(fn, iters)
        if ms is not None:
            return ms
    raise AssertionError(f"the profiler saw no device op in {PROFILE_TRIES} sessions")


def phase_segment(library_ms):
    """segment_add and segment_sum against index_add (their plain
    versions) at every SEGMENT_CASES case, int32 and int64, under the
    strategy segment_plan picks and under each other strategy that accepts
    the case, each as the round calls it (into zeros or onto x) and onto a
    seeded x. Per case: the plan, a profiler check of one call (one
    segment kernel, plus the plan's memset or copy, no clone or zero
    fill), and the times of the picked and of every accepted strategy:
    `ms` per call (CUDA events), `device_ms` per call (every device op of
    the call, torch.profiler), the plain version's ms (index_add under
    the deterministic switch that resolve_device turns on: it sorts) and
    library_ms (index_add in a child process without the switch). The
    kernel's own device ms per launch at SEGMENT_TIMED, int64
    (`kernel_device_ms`)."""
    import math

    import numpy as np
    import torch

    from armada_tpu_torch.ops import kernels as kt
    from armada_tpu_torch.timing import cuda_ms
    from armada_tpu_torch.tools.solve_ab import SEGMENT_CASES, segment_call, segment_inputs

    checks, cases = [], {}
    for i, (name, (shape, dim, k, form, order)) in enumerate(SEGMENT_CASES.items()):
        for dtype in (torch.int32, torch.int64):
            a = segment_inputs(name, dtype, i)
            x, _, index, values = a
            dims = (math.prod(shape[:dim]), shape[dim], k, math.prod(shape[dim + 1:]), x.element_size())
            rng = np.random.default_rng(1000 + i)
            info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
            x_rand = torch.as_tensor(rng.integers(info.min, info.max, size=shape, dtype=np.int64),
                                     device="cuda").to(dtype)
            want_add = kt.segment_add_plain(x_rand, dim, index, values)
            want = (kt.segment_sum_plain(values, index, shape[0]) if form == "sum"
                    else kt.segment_add_plain(x, dim, index, values))
            picked = kt.segment_plan(*dims)
            by = {}
            for strategy in kt.segment_strategies(*dims):
                plan = kt.segment_plan(*dims, strategy=strategy)
                call = segment_call(name, kt.segment_add, kt.segment_sum, a, plan=plan)
                case = dict(case=name, dtype=str(dtype), strategy=strategy)
                checks.append(check_equal("segment_add", (call(),), (want,), **case))
                checks.append(check_equal("segment_add", (kt.segment_add(x_rand, dim, index, values, plan=plan),),
                                          (want_add,), onto="seeded x", **case))
                by[strategy] = {"grid": plan.grid, "init": plan.init,
                                "ms": cuda_ms(call, 200), "device_ms": segment_device_ms(call, 50)}
            call = segment_call(name, kt.segment_add, kt.segment_sum, a)
            plain = segment_call(name, kt.segment_add_plain, kt.segment_sum_plain, a)
            # Each input read once, the output written once (x read too for
            # an add onto x, not for a sum into zeros); one add a value.
            nbytes = x.nbytes * (1 if form == "sum" else 2) + index.nbytes + values.nbytes
            bound_ms = max(nbytes / HBM_BYTES_PER_S, values.numel() / SCALAR_OPS_PER_S) * 1e3
            key = f"{name}_{str(dtype)[6:]}"
            cases[key] = {
                "strategy": picked.strategy, "grid": picked.grid, "init": picked.init,
                "wide": picked.wide,
                "ms": cuda_ms(call, 200),
                "device_ms": by[picked.strategy]["device_ms"],
                "plain_ms": cuda_ms(plain, 50),
                "library_ms": library_ms[key],
                "bound_ms": bound_ms,
                "profile": segment_profile(call, picked),
                "by": by,
                "shape": {"x": list(shape), "dim": dim, "k": k, "form": form, "index": order},
            }
            c = cases[key]
            c["bound_share"] = bound_ms / c["device_ms"] if c["device_ms"] else None
            if (name, dtype) == (SEGMENT_TIMED, torch.int64):
                timed = call
    tm = dict(cases[f"{SEGMENT_TIMED}_int64"])
    tm.pop("by")
    # device_ms is the whole sum as the round pays for it (the plan's
    # memset included), which bound_share reads; the kernel's own launch
    # beside it.
    tm["kernel_device_ms"] = device_ms_many({"kernel": timed}, 50, "segment_")["kernel"]
    tm["max_abs_err"] = max(c["max_abs_err"] for c in checks)
    tm["cases"] = cases
    return checks, tm


PROFILE_TRIES = 3


def device_ms_many(fns, iters, kernel):
    """device_ms for several callables in one profiler session. A session
    whose trace lacks some of the launches (torch.profiler has been seen to
    drop a session's kernel events on the card) is measured again, up to
    PROFILE_TRIES sessions in all; every number comes from one session that
    saw each launch."""
    from armada_tpu_torch.timing import device_ms as profiled

    for _ in range(PROFILE_TRIES):
        out = profiled(fns, iters, kernel)
        if all(ms is not None for ms in out.values()):
            return out
    raise AssertionError(
        f"the profiler did not see {iters} launches of {kernel} in any of {PROFILE_TRIES} sessions"
    )


PTXAS_SOURCES = ("fill_take", "winner_reduce", "segment_add")


def ptxas_start():
    """Start nvcc -Xptxas -v on csrc/fill_take.cu and csrc/winner_reduce.cu
    (beside the build)."""
    from armada_tpu_torch.ops import kernels as kt

    tmp = tempfile.mkdtemp(prefix="smoke-ptxas-")
    flags = [f for f in kt.NVCC_FLAGS if f != "-shared"]
    procs = {
        src: subprocess.Popen(
            [kt._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", os.path.join(tmp, f"{src}.cubin"),
             str(kt.CSRC / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src in PTXAS_SOURCES
    }
    return procs, tmp


def ptxas_finish(job):
    """Registers, shared memory, stack and spills of each fill_take_kernel
    instantiation, of the global sort's two kernels and of
    winner_reduce_kernel, from ptxas's report."""
    import re
    import shutil

    from armada_tpu_torch.ops import kernels as kt

    procs, tmp = job
    logs = {src: proc.communicate()[0] for src, proc in procs.items()}
    shutil.rmtree(tmp, ignore_errors=True)
    for src, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(f"nvcc -Xptxas -v failed for {src}.cu:\n{logs[src]}")
    log = "\n".join(logs.values())
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            width = re.search(r"winner_reduce_kernelILi(\d+)E", name)
            family = re.search(r"(segment_(?:rows|shared|gather)_kernel)", name)
            if family:  # the most of any instantiation, per kernel
                entry = family.group(1)
            elif width:
                entry = f"winner_reduce_kernel<{width.group(1)}>"
            elif "fill_take_kernel" in name:
                entry = "fill_take_kernel<resident>" if "ILb1E" in name else "fill_take_kernel<streamed>"
            else:  # fill_take.cu's global sort
                entry = "sort_runs_kernel" if "sort_runs_kernel" in name else "merge_kernel"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", line)
            stack = re.search(r"(\d+) bytes cumulative stack", line)
            rec = {
                "registers": int(m.group(1)),
                "static_smem_bytes": int(smem.group(1)) if smem else 0,
                "stack_bytes": int(stack.group(1)) if stack else 0,
            }
            if entry in out:
                rec = {f: max(out[entry][f], v) for f, v in rec.items()}
            out[entry] = rec
            if entry.startswith("fill_take"):
                out[entry]["dynamic_smem_bytes_max"] = kt.fill_take_config(131072, kt.FILL_TAKE_MAX).smem_bytes
            entry = None
    spills = [line.strip() for line in log.splitlines() if "spill" in line and "0 bytes spill" not in line]
    if spills:
        out["spills"] = spills
    return out


def winner_case(rng, p, n_keys, found_share):
    """Gathered winner tuples of P members on the card: duplicate-heavy
    leading keys and a permutation (the node rank) as the last key."""
    import numpy as np
    import torch

    keys = [rng.integers(0, 3, size=p).astype(np.int32) for _ in range(n_keys - 1)]
    keys.append(rng.permutation(p).astype(np.int32))
    found = rng.random(p) < found_share
    gids = rng.permutation(p).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device="cuda")

    return [t(k) for k in keys], t(found), t(gids)


def phase_winner():
    """winner_reduce against its plain version on the card: the row and
    the select's (gid, found), on P rows as the sharded select gathers
    them and on the reference's rows padded to a power of two; timing at
    the 2x2 round's shape (P = 2, K = 3) as the host stage calls it."""
    import numpy as np

    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.timing import cuda_ms

    rng = np.random.default_rng(2)
    checks = []
    for p in WINNER_ROWS:
        # Widths 3 to 7: 4-byte, 16-byte (K = 2) and 8-byte (K = 4) row loads.
        for n_keys in (1, 2, 3, 4, 5):
            for share in (0.5, 0.0):
                padded = K.winner_rows(*winner_case(rng, p, n_keys, share))
                for rows in (padded[:p], padded):
                    want = K.winner_reduce_plain(rows)
                    checks.append(check_equal(
                        "winner_reduce", K.winner_reduce_rows(rows, pick=True),
                        (want, *K.winner_pick_plain(want)),
                        p=p, rows=int(rows.shape[0]), k=n_keys, found_share=share,
                    ))
                    checks.append(check_equal(
                        "winner_reduce", [K.winner_reduce_rows(rows)], [want],
                        p=p, rows=int(rows.shape[0]), k=n_keys, found_share=share, pick=False,
                    ))
    rows = K.winner_rows(*winner_case(rng, 2, 3, 0.5))
    p, width = rows.shape
    timing = {
        "ms": cuda_ms(lambda: K.winner_reduce_rows(rows, pick=True), 500),
        "device_ms": device_ms(lambda: K.winner_reduce_rows(rows, pick=True), 200, "winner_reduce"),
        "plain_ms": cuda_ms(lambda: winner_plain_pick(K, rows), 100),
        # The rows read once; the row, the gid and found written once.
        "bound_ms": (p * width * 4 + width * 4 + 4 + 1) / HBM_BYTES_PER_S * 1e3,
        "library_ms": None,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "shape": {"P": p, "K": width - 2},
    }
    return checks, timing


def winner_plain_pick(K, rows):
    row = K.winner_reduce_plain(rows)
    return row, *K.winner_pick_plain(row)


def floor_device_ms():
    """The launch floor: device ms of a one-element torch add, the least a
    launch that does anything costs on this card."""
    import torch

    x = torch.zeros(1, device="cuda")
    return device_ms(lambda: x + 1, 200, "elementwise_kernel")


def assert_same_outputs(got, want, what):
    """Every output array of two solves equal in dtype, shape and bits (a
    host-driven solve's `truncated` and `profile` are not arrays and are
    left out)."""
    import numpy as np

    for key in want:
        if key in ("truncated", "profile"):
            continue
        x, y = np.asarray(got[key]), np.asarray(want[key])
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"{what} differ on {key}")


def run_sharded(dev, want, label, readback_rows, required):
    """One 2x2 sharded solve of `dev` on the "cuda" path, held to the
    single-device output `want`, with every kernel in `required` launched;
    returns its record."""
    import torch

    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.parallel.mesh import pad_nodes
    from armada_tpu_torch.parallel.multihost import resolve_solver
    from armada_tpu_torch.solver.validate import validate_round

    count = torch.cuda.device_count()
    devices = [f"cuda:{k % count}" for k in range(4)]
    run = resolve_solver("2x2", "cuda", devices=devices)
    d = pad_nodes(dev, run.n_shards)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = run(d, readback_rows=readback_rows)
    for name in dict.fromkeys(devices):
        torch.cuda.synchronize(name)
    solve_s = time.time() - t0
    launches = dict(K.LAUNCHES)
    assert_same_outputs(out, want, f"{label}: the sharded and single-device outputs")
    violation = validate_round(out, dev=d)
    if violation is not None:
        raise AssertionError(f"validate_round rejected the sharded {label}: {violation}")
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched in the sharded run")
    if "winner_reduce" in required:
        check_winner_launches(launches, run.last_stats.as_dict(), run.n_shards, label)
    return {
        "mesh": list(run.mesh_shape), "shards": {i: str(x) for i, x in enumerate(run.devices)},
        "solve_s": solve_s, "loops": int(out["num_loops"]), "loop_kinds": run.loop_stats,
        "launches": launches, "equals_single_device": True,
        "collective_stats": run.last_stats.as_dict(),
    }


def check_winner_launches(launches, stats, shards, label):
    """Both stages of every select through the winner kernel on a 2x2
    mesh: two launches per select per shard."""
    want = 2 * stats["selects"] * shards
    if stats["selects"] <= 0 or launches["winner_reduce"] != want:
        raise AssertionError(
            f"{label}: winner_reduce launched {launches['winner_reduce']} times, expected "
            f"2 x {stats['selects']} selects x {shards} shards = {want}"
        )


def run_round(n_jobs, n_nodes, paths, **inputs_kw):
    """Host prep once, then one solve per kernel path; returns timings,
    outputs by path and the padded round."""
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import N_RUNNING, build_inputs

    t0 = time.time()
    inputs = build_inputs(n_jobs, n_nodes, **inputs_kw)
    specs_s = time.time() - t0
    t0 = time.time()
    snap = build_round_snapshot(*inputs)
    dev = pad_device_round(prep_device_round(snap))
    prep_s = time.time() - t0
    res = {
        "jobs": n_jobs, "nodes": n_nodes, "running": inputs_kw.get("n_running", N_RUNNING),
        "gang_every": inputs_kw.get("gang_every", 0),
        "fast_fill": bool(dev.fast_fill), "fill_window": int(dev.batch_window),
        "specs_s": specs_s, "host_prep_s": prep_s,
    }
    res, outs = solve_paths(dev, paths, int(snap.num_jobs), res)
    return res, outs, dev


def solve_paths(dev, paths, readback_rows, res=None, required=FILL_KERNELS):
    """One solve of the padded round per kernel path, each admitted by the
    round firewall, the "cuda" path with the kernels of `required` (the
    fill kernels and the segment kernel by default) launched (the counts set to 0 just before
    each solve and read just after); returns (record, outputs by path)."""
    import dataclasses

    import numpy as np
    import torch

    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.solver import kernel as kernel_mod
    from armada_tpu_torch.solver.validate import validate_round

    res = dict(res or {})
    res.update({
        "padded": {"J": int(dev.job_req.shape[0]), "N": int(dev.node_total.shape[0]),
                   "S": int(dev.slot_members.shape[0])},
        "readback_rows": readback_rows,
    })
    outs = {}
    for path in paths:
        d = dataclasses.replace(dev, kernel_path=path)
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        stats = {}
        out = kernel_mod.solve_round(d, readback_rows=readback_rows, stats=stats)
        torch.cuda.synchronize()
        res[f"{path}_cold_solve_s"] = time.time() - t0
        res[f"{path}_cold_launches"] = dict(K.LAUNCHES)
        res[f"{path}_loops"] = int(out["num_loops"])
        res[f"{path}_loop_kinds"] = stats
        res[f"{path}_scheduled"] = int(np.asarray(out["scheduled_mask"]).sum())
        res[f"{path}_preempted"] = int(np.asarray(out["preempted_mask"]).sum())
        t0 = time.time()
        violation = validate_round(out, dev=d)
        res[f"{path}_validate_s"] = time.time() - t0
        if violation is not None:
            raise AssertionError(f"validate_round rejected the {path} round: {violation}")
        if path == "cuda":
            # The single-device path's kernels; winner_reduce runs only
            # on a mesh with more than one host (phase 7).
            for name in required:
                if res["cuda_cold_launches"][name] <= 0:
                    raise AssertionError(f"kernel {name} was not launched on the cuda path")
        outs[path] = out
    return res, outs


def require_launch(res, what):
    """Raise with every worker's last output when a launch failed."""
    if not res["ok"]:
        for rank, tail in enumerate(res.get("tails", [])):
            print(f"--- {what}: worker {rank} ---\n{tail}", file=sys.stderr)
        raise AssertionError(
            f"{what}: launch failed (returncodes {res['returncodes']}, timed out "
            f"{res['timed_out']}, mismatch {res.get('mismatch')})"
        )


def ring_record(res):
    """Per axis of a launch's ring drive: n, launches and the worst error
    summed and maxed over the ranks, each rank's times."""
    out = {}
    for axis in res["workers"][0]["ring"]:
        per_rank = [w["ring"][axis] for w in res["workers"]]
        if any(r["mismatches"] for r in per_rank):
            raise AssertionError(f"ring_exchange disagrees with its plain version over {axis}")
        keys = ("ms", "device_ms", "plain_ms", "gather_reduce_ms")
        out[axis] = {
            "n": per_rank[0]["n"],
            "calls": sum(c["calls"] for c in per_rank[0]["cases"]),
            "launches": sum(r["launches"] for r in per_rank),
            "max_abs_err": max(r["max_abs_err"] for r in per_rank),
            **{k: [r[k] for r in per_rank] for k in keys},
        }
    return out


def phase_multiproc(dev, want, readback_rows, inproc_stats):
    """gangs_100k on a 2x2 grid of worker processes on the card, held to
    its single-device solve, then the ring drive; a ring-only 1x4 launch."""
    import torch

    from armada_tpu_torch.parallel.launcher import launch, save_round
    from armada_tpu_torch.parallel.mesh import pad_nodes
    from armada_tpu_torch.solver.validate import validate_round

    count = torch.cuda.device_count()
    devices = [f"cuda:{k % count}" for k in range(4)]
    d = pad_nodes(dev, 4)
    with tempfile.TemporaryDirectory(prefix="smoke-multiproc-") as tmp:
        path = save_round(d, os.path.join(tmp, "round.npz"))
        solve = launch(path, 2, 2, devices=devices, backend="gloo", kernel_path="cuda",
                       timeout_s=600.0, out_dir=tmp, readback_rows=readback_rows,
                       ring_calls=RING_CALLS)
    require_launch(solve, "2x2 gangs_100k")
    assert_same_outputs(solve["outputs"], want, "multiproc gangs_100k: rank 0 and the single device")
    violation = validate_round(solve["outputs"], dev=d)
    if violation is not None:
        raise AssertionError(f"validate_round rejected the multi-process gangs_100k: {violation}")
    for name in ROUND_KERNELS:
        if solve["launches"][name] <= 0:
            raise AssertionError(f"multiproc gangs_100k: kernel {name} was not launched")
    check_winner_launches(solve["launches"], solve["collectives"], 4, "multiproc gangs_100k")
    if solve["collectives"] != inproc_stats:
        raise AssertionError(
            f"multiproc CollectiveStats {solve['collectives']} differ from the in-process "
            f"run's {inproc_stats}"
        )
    ring = launch(None, 1, 4, devices=devices, backend="gloo", timeout_s=300.0,
                  ring_calls=RING_CALLS)
    require_launch(ring, "1x4 ring")
    runs = {"gangs_100k_2x2": solve, "ring_1x4": ring}
    rec = {
        name: {
            "mesh": [r["hosts"], r["chips"]], "backend": r["backend"],
            "ranks": {w["rank"]: w["device"] for w in r["workers"]},
            "init_s": [w["init_s"] for w in r["workers"]],
            "launch_s": r["seconds"], "ring": ring_record(r),
        }
        for name, r in runs.items()
    }
    g = rec["gangs_100k_2x2"]
    g["solve_s"] = [w["solve_s"] for w in solve["workers"]]
    g["loops"] = solve["workers"][0]["loops"]
    g["loop_kinds"] = solve["workers"][0]["loop_stats"]
    g["launches"] = solve["launches"]
    g["equals_single_device"] = True
    g["collective_stats_equal_in_process"] = True
    g["collective_stats"] = solve["collectives"]
    return rec


def ring_timing(rec):
    """The ring kernel's line entries at n = 4, K = 3 (the 1x4 chip axis)
    and at n = 2 (the 2x2 grid's chip axis), means over the members, and
    its launches over both launches."""
    chips = rec["ring_1x4"]["ring"]["chips"]
    pair = rec["gangs_100k_2x2"]["ring"]["chips"]
    mean = lambda xs: sum(xs) / len(xs) if all(x is not None for x in xs) else None  # noqa: E731
    n, width = chips["n"], 3 + 2
    launches = sum(a["launches"] for r in rec.values() for a in r["ring"].values())
    if launches <= 0:
        raise AssertionError("kernel ring_exchange was not launched in the multi-process runs")
    return {
        "ms": mean(chips["ms"]),
        "device_ms": mean(chips["device_ms"]),
        "plain_ms": mean(chips["plain_ms"]),
        "gather_reduce_ms": mean(chips["gather_reduce_ms"]),
        "ms_n2": mean(pair["ms"]),
        "device_ms_n2": mean(pair["device_ms"]),
        # One member's function: its own row and the n - 1 peers' rows read
        # once, the result row written once.
        "bound_ms": (n + 1) * width * 4 / HBM_BYTES_PER_S * 1e3,
        "library_ms": None,
        "max_abs_err": max(a["max_abs_err"] for r in rec.values() for a in r["ring"].values()),
        "launches": launches,
        "shape": {"n": n, "K": width - 2},
    }


def require_merged(rec, paths, what):
    """Fast fill ran: merged loops on every path, no single-queue fill."""
    for path in paths:
        kinds = rec[f"{path}_loop_kinds"]
        if kinds["merged_fill_loops"] <= 0 or kinds["fill_loops"] != 0:
            raise AssertionError(f"{what}: no merged fill on the {path} path ({kinds})")


def phase_fast_fill(dev_flag, flag_rows):
    """Fast fill (the merged multi-queue window fill and the evicted-rebind
    window) on the card:
    - round_100k at a window of 512 on "cuda" and "lax", bit-equal;
    - the flagship in the bench's configuration (window 2,048): phase 5's
      padded round under that fill configuration (`workload.refill`,
      equal to a fresh prep: tests/test_torch_fast_fill.py), on "cuda";
    - the home/away round at 16,384 nodes x 65,536 jobs (the reference's
      multichip dryrun size; its config has fast fill on): "cuda" and
      "lax" bit-equal, then 2x2 shard threads held to the single device,
      the round that evicts and selects nodes at scale;
    - a window of 4,096 on 5,000 nodes (8,192 padded), 20,000 queued
      jobs: every fill group's fill_take at want 4,096, past the
      survivors' shared-memory budget, "cuda" equal to "lax".
    Each admitted by the round firewall, with both fill kernels launched
    on "cuda"; loops and host seconds by kind in each record. Returns the
    records, (the flagship_fast round, its "cuda" output), which the
    driver phase and the sharded phase solve again, and the round_100k
    fast-fill round, whose policy variants the policies phase solves."""
    from armada_tpu_torch.parallel.scenarios import home_away_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import refill, scheduling_config

    rec = {}
    r100, outs, dev_100k = run_round(100_000, 5000, ("cuda", "lax"), fast_fill=True, fill_window=512)
    assert_same_outputs(outs["cuda"], outs["lax"], "round_100k fast fill: the cuda and lax paths")
    require_merged(r100, ("cuda", "lax"), "round_100k fast fill")
    r100["cuda_equals_lax"] = True
    rec["round_100k_fast"] = r100
    del outs

    t0 = time.time()
    d = refill(dev_flag, scheduling_config(fast_fill=True, fill_window=2048))
    flag, flag_outs = solve_paths(d, ("cuda",), flag_rows,
                                  {"jobs": 1_000_000, "nodes": 50_000, "fast_fill": True,
                                   "fill_window": 2048, "refill_s": time.time() - t0})
    require_merged(flag, ("cuda",), "flagship fast fill")
    rec["flagship_fast"] = flag
    fast_round = (d, flag_outs["cuda"])

    t0 = time.time()
    snap = home_away_round(16384, 65536)
    dev = pad_device_round(prep_device_round(snap))
    ha, outs = solve_paths(dev, ("cuda", "lax"), int(snap.num_jobs),
                           {"nodes": 16384, "jobs": 65536, "fast_fill": bool(dev.fast_fill),
                            "fill_window": int(dev.batch_window),
                            "host_prep_s": time.time() - t0})
    assert_same_outputs(outs["cuda"], outs["lax"], "home_away: the cuda and lax paths")
    require_merged(ha, ("cuda", "lax"), "home_away")
    ha["cuda_equals_lax"] = True
    rec["home_away"] = ha
    rec["home_away_2x2"] = run_sharded(
        dev, outs["cuda"], "home_away", int(snap.num_jobs), ROUND_KERNELS
    )
    if rec["home_away_2x2"]["loop_kinds"]["merged_fill_loops"] <= 0:
        raise AssertionError("home_away 2x2: no merged fill")
    del outs, dev

    w4, outs, dev = run_round(20_000, 5000, ("cuda", "lax"), n_running=0, fast_fill=True,
                              fill_window=4096)
    assert_same_outputs(outs["cuda"], outs["lax"], "window 4,096: the cuda and lax paths")
    require_merged(w4, ("cuda", "lax"), "window 4,096")
    want = min(4096, int(dev.node_total.shape[0]))
    sorts = w4["cuda_cold_launches"]["fill_take_global_sort"]
    if sorts <= 0:
        raise AssertionError(f"window 4,096: no fill_take sorted in the global scratch (want {want})")
    w4["cuda_equals_lax"] = True
    w4["fill_take_want"] = want
    w4["fill_take_global_sort_launches"] = int(sorts)
    rec["window_4096"] = w4
    del outs, dev
    return rec, fast_round, dev_100k


def drive(dev, label, rows=None, **kw):
    """One host-driven solve of `dev` on its kernel path (the counts set
    to 0 just before it and read just after), admitted by the round
    firewall; returns (record, outputs). `kw` goes to solve_round
    (budget_s, window, window_min_slots)."""
    import numpy as np
    import torch

    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.solver import kernel as kernel_mod
    from armada_tpu_torch.solver.validate import validate_round

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    stats = {}
    out = kernel_mod.solve_round(dev, readback_rows=rows, stats=stats, **kw)
    torch.cuda.synchronize()
    rec = {
        "path": dev.kernel_path, **{k: v for k, v in kw.items()},
        "solve_s": time.time() - t0, "launches": dict(K.LAUNCHES),
        "loops": int(out["num_loops"]), "loop_kinds": stats,
        "truncated": out.get("truncated"), "profile": out["profile"],
        "scheduled": int(np.asarray(out["scheduled_mask"]).sum()),
        "preempted": int(np.asarray(out["preempted_mask"]).sum()),
    }
    violation = validate_round(out, dev=dev)
    if violation is not None:
        raise AssertionError(f"validate_round rejected {label}: {violation}")
    if dev.kernel_path == "cuda":
        for name in FILL_KERNELS:
            if rec["launches"][name] <= 0:
                raise AssertionError(f"{label}: kernel {name} was not launched")
    return rec, out


def require_equal_round(rec, out, want, want_kinds, label, compacted=True):
    """A host-driven solve equal to the fused one: every array, num_loops
    and the loop counts by kind; compacted as asked."""
    assert_same_outputs({k: out[k] for k in want}, want, f"{label}: the driven and fused outputs")
    if rec["profile"]["compacted"] != compacted:
        raise AssertionError(f"{label}: compacted is {rec['profile']['compacted']}")
    kinds = ("gang_loops", "fill_loops", "merged_fill_loops")
    if {k: rec["loop_kinds"][k] for k in kinds} != {k: want_kinds[k] for k in kinds}:
        raise AssertionError(f"{label}: loop kinds {rec['loop_kinds']} differ from {want_kinds}")
    rec["equals_fused"] = True


def require_prefix(cut, full, label):
    """A truncated round's placements a subset of the full round's, on the
    same nodes, and its preemptions a subset of the full round's."""
    import numpy as np

    placed = np.flatnonzero(cut["scheduled_mask"])
    if not np.asarray(full["scheduled_mask"])[placed].all():
        raise AssertionError(f"{label}: placed jobs the full round does not place")
    if not (cut["assigned_node"][placed] == full["assigned_node"][placed]).all():
        raise AssertionError(f"{label}: placed jobs on other nodes than the full round")
    pre = np.asarray(cut["preempted_mask"])
    if (pre & ~np.asarray(full["preempted_mask"])).any():
        raise AssertionError(f"{label}: preempted jobs the full round keeps")
    return {"placed": int(len(placed)), "placed_full": int(np.asarray(full["scheduled_mask"]).sum()),
            "preempted": int(pre.sum()), "preempted_full": int(np.asarray(full["preempted_mask"]).sum()),
            "prefix_of_full": True}


def phase_driver(dev_flag, flag, flag_out, dev_fast, fast, fast_out, quarter):
    """The host-driven driver (round budget, rescue pass, hot window) as the
    scheduler asks for it, each run admitted by the round firewall, with
    score_nodes and fill_take launched on "cuda":
    - flagship_window: phase 5's flagship at the scheduler's default hot
      window (4,096 slots, the default min-slots floor): compacted and
      bit-equal to phase 5's fused output, loop kinds included; its solve
      seconds beside phase 5's fused seconds;
    - flagship_fast_window: phase 6's flagship_fast at the same window,
      compacted and bit-equal to phase 6's fused output;
    - round_25k_budget: round_25k (phase 7's eviction round) at
      budget_s=1e-6 on "cuda" and "lax": truncated after one pass-1 loop,
      the paths bit-equal, placements and preemptions subsets of the full
      round's;
    - flagship_budget: flagship_window at budget_s=5.0, Armada's
      maxSchedulingDuration: a prefix of flagship_window (times depend on
      the wall clock and are not compared);
    - home_away_window: the home/away round at 4,096 nodes x 16,384 jobs,
      window 64 (rounded up to its fill window of 512) and no min-slots
      floor: compacted with rewindows, bit-equal to its fused solve."""
    import dataclasses

    from armada_tpu_torch.parallel.scenarios import home_away_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round

    rec = {}
    rows = flag["readback_rows"]
    win, win_out = drive(dev_flag, "flagship_window", rows, window=4096)
    require_equal_round(win, win_out, flag_out, flag["cuda_loop_kinds"], "flagship_window")
    win["fused_solve_s"] = flag["cuda_cold_solve_s"]
    rec["flagship_window"] = win

    fw, out = drive(dev_fast, "flagship_fast_window", rows, window=4096)
    require_equal_round(fw, out, fast_out, fast["cuda_loop_kinds"], "flagship_fast_window")
    fw["fused_solve_s"] = fast["cuda_cold_solve_s"]
    rec["flagship_fast_window"] = fw
    del out

    q_rec, q_outs, q_dev = quarter
    cuts = {}
    for path in ("cuda", "lax"):
        r, cuts[path] = drive(dataclasses.replace(q_dev, kernel_path=path), f"round_25k_budget/{path}",
                              q_rec["readback_rows"], budget_s=1e-6)
        if r["truncated"] is not True:
            raise AssertionError(f"round_25k_budget/{path}: not truncated")
        rec[f"round_25k_budget_{path}"] = r
    assert_same_outputs(cuts["cuda"], cuts["lax"], "round_25k_budget: the cuda and lax paths")
    rec["round_25k_budget_cuda"]["cuda_equals_lax"] = True
    rec["round_25k_budget_cuda"].update(require_prefix(cuts["cuda"], q_outs["cuda"], "round_25k_budget"))
    del cuts

    b, out = drive(dev_flag, "flagship_budget", rows, window=4096, budget_s=5.0)
    b.update(require_prefix(out, win_out, "flagship_budget"))
    rec["flagship_budget"] = b
    del out, win_out

    t0 = time.time()
    snap = home_away_round(4096, 16384)
    dev = pad_device_round(prep_device_round(snap))
    prep_s = time.time() - t0
    ha, outs = solve_paths(dev, ("cuda",), int(snap.num_jobs),
                           {"nodes": 4096, "jobs": 16384, "host_prep_s": prep_s})
    hw, out = drive(dev, "home_away_window", int(snap.num_jobs), window=64, window_min_slots=0)
    require_equal_round(hw, out, outs["cuda"], ha["cuda_loop_kinds"], "home_away_window")
    if hw["profile"]["rewindows"] < 1:
        raise AssertionError("home_away_window: no rewindow")
    hw["fused"] = ha
    hw["fused_solve_s"] = ha["cuda_cold_solve_s"]
    rec["home_away_window"] = hw
    return rec


def phase_policies(dev_flag, flag, dev_fast, fast, dev_100k):
    """The fairness policies on the card: each run's round is a prepared
    round of an earlier phase with its policy fields replaced
    (`workload.repolicy`: queue weights 1 to 10 in name order, for the
    deadline policy an hour between queue deadlines and every third
    queue without one; equal to a fresh prep, tests/test_torch_policy.py),
    and each is admitted by the round firewall with both fill kernels
    launched on "cuda":
    - flagship_fast (phase 6, window 2,048) and round_100k_fast (phase 6,
      window 512, balance eviction and the evicted-rebind window) under
      proportional, priority and deadline: "cuda" bit-equal to "lax";
    - the fused flagship (phase 5, the single-queue fill) under priority:
      "cuda" bit-equal to "lax";
    - flagship_fast under priority on a 2x2 mesh of shard threads, held
      to its single-device output.
    Each record holds the loops by kind, the solve seconds and the
    launches, and the DRF round's loops beside them (`drf_loops`)."""
    from armada_tpu_torch.workload import POLICY_KINDS, repolicy

    rec = {}
    rows = flag["readback_rows"]
    rec_100k = fast["round_100k_fast"]
    bases = (
        ("flagship_fast", dev_fast, rows, fast["flagship_fast"]["cuda_loops"]),
        ("round_100k_fast", dev_100k, rec_100k["readback_rows"], rec_100k["cuda_loops"]),
    )
    keep = None
    for kind in POLICY_KINDS:
        for label, base, base_rows, drf_loops in bases:
            d = repolicy(base, kind)
            r, outs = solve_paths(d, ("cuda", "lax"), base_rows,
                                  {"policy": list(d.fairness_policy), "drf_loops": drf_loops})
            what = f"{label} under {kind}"
            assert_same_outputs(outs["cuda"], outs["lax"], f"{what}: the cuda and lax paths")
            require_merged(r, ("cuda", "lax"), what)
            r["cuda_equals_lax"] = True
            rec[f"{label}_{kind}"] = r
            if label == "flagship_fast" and kind == "priority":
                keep = (d, outs["cuda"])
            del outs, d

    d = repolicy(dev_flag, "priority")
    r, outs = solve_paths(d, ("cuda", "lax"), rows,
                          {"policy": list(d.fairness_policy), "drf_loops": flag["cuda_loops"]})
    assert_same_outputs(outs["cuda"], outs["lax"], "flagship under priority: the cuda and lax paths")
    r["cuda_equals_lax"] = True
    rec["flagship_priority"] = r
    del outs, d

    d, out = keep
    rec["flagship_fast_priority_2x2"] = run_sharded(
        d, out, "flagship_fast under priority", rows, FILL_KERNELS
    )
    return rec


def phase_market():
    """Market rounds on the card (parallel/scenarios.py `market_round`:
    bid order, the spot price, market eviction of every bound job, gangs
    of 2, 4 and 8), each admitted by the round firewall:
    - market_scarce, market_round(128, 8192): the cutoff is crossed, so
      a spot price is set, and jobs are preempted;
    - market_fleet, market_round(2048, 8192), the market round of
      mixed_fleet_rounds(16384, 65536).
    Each on one device on "cuda", where it launches only the segment
    kernel (a market round takes no fill: prep sets its window to 0, and
    selects no node on one device); market_scarce then on a 2x2 mesh of shard threads
    held to the single device, with both stages of every select through
    winner_reduce. market_fleet's 2x2 run (the same code at 16 times the
    nodes) was cut for the smoke's time limit."""
    from armada_tpu_torch.parallel.scenarios import market_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round

    rec = {}
    for label, n_nodes, n_jobs in (("market_scarce", 128, 8192), ("market_fleet", 2048, 8192)):
        t0 = time.time()
        snap = market_round(n_nodes, n_jobs)
        dev = pad_device_round(prep_device_round(snap))
        rows = int(snap.num_jobs)
        r, outs = solve_paths(dev, ("cuda",), rows,
                              {"nodes": n_nodes, "jobs": n_jobs, "host_prep_s": time.time() - t0},
                              required=("segment_add",))
        if dev.batch_window != 0 or any(
                r["cuda_cold_launches"][k] for k in ("score_nodes", "fill_take", "winner_reduce")):
            raise AssertionError(f"{label}: a kernel launched in a market round on one device "
                                 f"({r['cuda_cold_launches']})")
        spot = float(outs["cuda"]["spot_price"])
        r["spot_price"] = None if spot != spot else spot  # NaN: the cutoff was not crossed
        rec[label] = r
        if label == "market_scarce":
            rec[f"{label}_2x2"] = run_sharded(dev, outs["cuda"], label, rows, ("winner_reduce",))
        del outs, dev
    return rec


WARM_CYCLES = 5  # measured warm cycles, after one that settles the shapes


def _fresh_equal(warm, label):
    """Hold the last warm solve to a solve of a fresh upload of the same
    generation (`pad_device_round(inc.device_round())`), every array;
    returns the seconds of that prep and pad."""
    fresh, prep_s = warm.fresh_solve()
    assert_same_outputs(warm.out, fresh, f"{label}: the resident and fresh-upload solves")
    return prep_s


def _check_warm_cycle(warm, rec, reset_bytes, label):
    """A measured warm cycle's checks, made after its timed part."""
    sync = rec["sync"]
    if sync["mode"] != "delta" or not sync["bytes_up"] < reset_bytes:
        raise AssertionError(f"{label}: sync {sync['mode']}, {sync['bytes_up']} bytes up "
                             f"against the reset's {reset_bytes}")
    if rec["transfer"]["bytes_up"] != 0:
        raise AssertionError(f"{label}: the solve booked {rec['transfer']['bytes_up']} bytes up")
    if rec["violation"] is not None:
        raise AssertionError(f"{label}: validate_round rejected the round: {rec['violation']}")
    drift = warm.resident.check_drift()
    if drift:
        raise AssertionError(f"{label}: the resident round drifted on {drift}")
    for name in FILL_KERNELS:
        if rec["launches"].get(name, 0) <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched")
    rec["prep_pad_s"] = _fresh_equal(warm, label)


def _quartiles(xs):
    import statistics

    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return q1, q2, q3


def phase_warm():
    """The warm scheduling cycle as bench.py runs it (`workload.WarmCycle`:
    leases of last round's decisions and as many fresh 2-cpu / 4Gi submits
    into an IncrementalRound, a delta sync of the ResidentRound on the
    card, the host-driven solve at hot window 2 x the fill window with no
    floor, the round firewall on the host mirror):
    - the flagship in bench.py's configuration (1M jobs x 50k nodes,
      fast fill, window 2,048): the reset upload and the cold solve, one
      cycle that settles the shapes, then WARM_CYCLES measured cycles,
      each a "delta" sync below the reset's bytes, a solve booking no
      upload with score_nodes and fill_take launched, no drift after it,
      and outputs bit-equal to a solve of a fresh upload of the same
      generation (made after the cycle's timed part). Then the last
      cycle's resident tree on "lax", equal to "cuda". The record holds the median
      cycle_s with its min, max and quartiles, the median cycle's parts,
      the bytes of the reset and of each delta, and the last cycle's Jain
      index and max regret (observe/fairness.py);
    - round_25k's shape (25k jobs x 1.25k nodes x 1,250 running, the same
      configuration): a burst of submits past the padded pow2 capacity
      syncs as a "reset" into regrown buffers and stays bit-equal, the
      next cycle is "delta" again; one field corrupted on the card is the
      one check_drift names, and after reset() the next sync is a clean
      reset."""
    import dataclasses

    import torch

    from armada_tpu_torch.core.types import JobSpec
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.workload import WarmCycle, build_inputs

    rec = {}
    t0 = time.time()
    warm = WarmCycle(build_inputs(1_000_000, 50_000, fast_fill=True, fill_window=2048))
    rec["build_s"] = time.time() - t0
    rec["window"] = warm.window
    cold = warm.cold()
    reset_bytes = cold["sync"]["bytes_up"]
    rec["cold"] = {"h2d_s": cold["h2d_s"], "solve_s": cold["solve_s"], "reset_bytes_up": reset_bytes,
                   "padded": {"J": int(warm.resident.host_round().job_req.shape[0]),
                              "N": int(warm.resident.host_round().node_total.shape[0]),
                              "S": int(warm.resident.host_round().slot_members.shape[0])}}
    _fresh_equal(warm, "flagship cold")
    settle = warm.cycle()
    rec["settle"] = {k: settle[k] for k in ("cycle_s", "loops", "scheduled_jobs", "leased")}
    rec["settle"]["sync"] = {k: settle["sync"][k] for k in ("mode", "bytes_up", "permuted")}
    cycles = []
    for i in range(WARM_CYCLES):
        K.reset_launches()
        c = warm.cycle()
        c["launches"] = dict(K.LAUNCHES)
        _check_warm_cycle(warm, c, reset_bytes, f"flagship warm cycle {i}")
        c["delta_bytes_up"] = c["sync"]["bytes_up"]
        c["sync"] = {**{k: c["sync"][k] for k in ("mode", "bytes_up", "permuted")},
                     "fields_synced": len(c["sync"]["fields"])}
        cycles.append(c)
    times = sorted(c["cycle_s"] for c in cycles)
    q1, median, q3 = _quartiles(times)
    rep = min(cycles, key=lambda c: abs(c["cycle_s"] - median))
    rec["cycles"] = cycles
    rec["cycle_s"] = {"median": median, "min": times[0], "max": times[-1], "q1": q1, "q3": q3,
                      "iqr": q3 - q1}
    rec["median_cycle"] = {k: rep[k] for k in ("delta_s", "h2d_s", "snapshot_s", "prep_pad_s",
                                               "solve_s", "validate_s", "cycle_s", "loops",
                                               "scheduled_jobs")}
    rec["bytes_up"] = {"reset": reset_bytes, "delta_median": rep["delta_bytes_up"],
                       "reset_over_delta": reset_bytes / max(1, rep["delta_bytes_up"])}
    rec["launches_warm_cycles"] = {
        name: int(sum(c["launches"].get(name, 0) for c in cycles)) for name in K.KERNELS}
    rec["fairness"] = warm.fairness()

    dev = warm.resident.device_round(warm.inc)
    host = warm.resident.host_round()
    rows = warm.inc.snapshot().num_jobs
    K.reset_launches()
    lax = warm.solve(dataclasses.replace(dev, kernel_path="lax"), host, rows)
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"the lax path launched a kernel: {dict(K.LAUNCHES)}")
    assert_same_outputs(lax, warm.out, "flagship warm: the lax and cuda solves of the resident tree")
    rec["lax_equals_cuda"] = True
    del lax, dev, host, warm
    torch.cuda.empty_cache()

    t0 = time.time()
    warm = WarmCycle(build_inputs(25_000, 1250, n_running=1250, fast_fill=True, fill_window=2048))
    warm.cold()
    first = warm.cycle()
    if first["sync"]["mode"] != "delta":
        raise AssertionError(f"round_25k: the first cycle synced as {first['sync']['mode']}")
    j0 = int(warm.resident.host_round().job_req.shape[0])
    live = warm.inc.snapshot().num_jobs
    burst = j0 - live + 1
    warm.inc.add_jobs([
        JobSpec(id=f"burst-{i:06d}", queue=warm.queues[i % len(warm.queues)], priority_class="low",
                requests={"cpu": "2", "memory": "4Gi"}, submitted_ts=4e6 + i)
        for i in range(burst)
    ])
    grown = warm.cycle()
    j1 = int(warm.resident.host_round().job_req.shape[0])
    if grown["sync"]["mode"] != "reset" or not j1 > j0:
        raise AssertionError(f"round_25k: a burst past J = {j0} synced as {grown['sync']['mode']}, "
                             f"J = {j1}")
    if warm.resident.check_drift():
        raise AssertionError("round_25k: the regrown round drifted")
    _fresh_equal(warm, "round_25k regrown")
    after = warm.cycle()
    if after["sync"]["mode"] != "delta":
        raise AssertionError(f"round_25k: the cycle after the regrow ({after['leased']} leases) "
                             f"synced as {after['sync']['mode']}")
    _fresh_equal(warm, "round_25k after the regrow")
    dev = warm.resident.device_round(warm.inc)
    dev.job_prio[0] += 1
    drift = warm.resident.check_drift()
    if drift != ["job_prio"]:
        raise AssertionError(f"round_25k: check_drift named {drift}, not ['job_prio']")
    warm.resident.reset()
    clean = warm.cycle()
    if clean["sync"]["mode"] != "reset" or warm.resident.check_drift():
        raise AssertionError("round_25k: the sync after reset() was not a clean reset")
    _fresh_equal(warm, "round_25k after reset()")
    rec["round_25k"] = {
        "padded_j": [j0, j1], "burst": burst,
        "syncs": [first["sync"]["mode"], grown["sync"]["mode"], after["sync"]["mode"],
                  clean["sync"]["mode"]],
        "bytes_up": [first["sync"]["bytes_up"], grown["sync"]["bytes_up"],
                     after["sync"]["bytes_up"], clean["sync"]["bytes_up"]],
        "drift_named": drift, "seconds": time.time() - t0,
    }
    return rec


def require_fill_launches(launches, label):
    for name in FILL_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched")


def take_launches(totals, label, extra=()):
    """This process's launches since the last take (the counts are set to
    0 after), plus `extra`, the launch counts of what-if rollouts, made in
    their processes and sent back with the plans; added into `totals`.
    Every fill kernel must have launched."""
    from armada_tpu_torch.ops import kernels as K

    got = dict(K.LAUNCHES)
    K.reset_launches()
    for more in extra:
        for name, n in more.items():
            got[name] = got.get(name, 0) + n
    for name in totals:
        totals[name] += got[name]
    require_fill_launches(got, label)
    return got


def plan_costs(stats):
    """A planner's `plan_stats` without the launches (counted apart) and
    the rollouts' leases and preemptions."""
    return [{k: v for k, v in s.items() if k not in ("launches", "leases", "preempts")}
            for s in stats]


SERVICE_WARM_CYCLES = 4  # service_100k: warm cycles after the cold one, each service
FLAGSHIP_SERVICE_WARM_CYCLES = 1  # service_flagship (cut from 3 for the time limit)


def _require_warm(compiles, label):
    """A warm cycle builds and loads no kernel library."""
    if compiles is None or compiles["compiles"] or compiles["traces"]:
        raise AssertionError(f"{label}: a warm round built or loaded a kernel library "
                             f"({compiles})")


def _service_run(cfg, entries, n_nodes, kernel_path, cycles, label):
    """A ServiceRun (workload.py) of `cycles` cycles on the card with its
    launch counts, held to the phase's per-cycle checks: the card's
    ladder is the configured kernel path alone (no "lax" or host rung
    below it), every round on it with no failover, admitted by the firewall,
    "resident" with a "delta" sync from the second cycle on, and no drift
    after the last."""
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.workload import ServiceRun

    K.reset_launches()
    run = ServiceRun(cfg, entries, n_nodes, kernel_path=kernel_path)
    ladder = [r.label for r in run.sched._rungs]
    if ladder != ["LOCAL" if kernel_path == "lax" else f"local:{kernel_path}"]:
        raise AssertionError(f"{label}: the card's ladder is {ladder}")
    first_rung = ladder[0]
    records = [run.cycle() for _ in range(cycles)]
    launches = dict(K.LAUNCHES)
    for i, rec in enumerate(records):
        st = rec["stats"]
        if st["rung"] != first_rung or st["failover"] is not None:
            raise AssertionError(f"{label} cycle {i}: rung {st['rung']}, failover {st['failover']}")
        if i and (st["snapshot_mode"] != "resident" or st["sync"]["mode"] != "delta"):
            raise AssertionError(f"{label} cycle {i}: {st['snapshot_mode']} round, "
                                 f"sync {(st['sync'] or {}).get('mode')}")
        if i:
            _require_warm(st["compiles"], f"{label} cycle {i}")
        if not rec["leases"]:
            raise AssertionError(f"{label} cycle {i}: nothing leased")
    sched = run.sched
    if sched.recent_failovers or sched.recent_rejections:
        raise AssertionError(f"{label}: failovers {list(sched.recent_failovers)}, "
                             f"rejections {list(sched.recent_rejections)}")
    drift = sched._resident["default"].check_drift()
    if drift:
        raise AssertionError(f"{label}: the resident round drifted in {drift}")
    summary = {
        "ingest_s": run.ingest_s,
        "ladder": ladder,
        "launches": launches,
        "cycles": [{
            "leased": len(r["leases"]), "preempted": len(r["preempted"]),
            "cycle_s": r["cycle_s"], "snapshot_s": r["stats"]["snapshot_s"],
            "sync_s": r["stats"]["sync_s"], "solve_s": r["stats"]["solve_s"],
            "snapshot_mode": r["stats"]["snapshot_mode"],
            "sync": (r["stats"]["sync"] or {}).get("mode"),
            "bytes_up": (r["stats"]["sync"] or {}).get("bytes_up"),
            "rung": r["stats"]["rung"], "jobs": r["stats"]["jobs"],
            "compiles": r["stats"]["compiles"],
        } for r in records],
    }
    history = [(r["leases"], r["preempted"]) for r in records]
    return summary, history


def phase_service():
    """The scheduler service on the card (services/scheduler.py), fed
    through the control plane (workload.submit_events, ServiceRun):
    - service_100k: round_100k's queued jobs (100,000 in 10 queues, no
      running jobs) submitted through the SubmitService, two fake
      executors of 2,500 nodes each, the bench's config (fast fill,
      window 2,048, default rate limits); one service on the "cuda" path
      and one on "lax", fed the same events, 1 cold and
      SERVICE_WARM_CYCLES warm cycles each: equal leases and preemptions
      cycle by cycle, the per-cycle checks of `_service_run`, both fill
      kernels launched by the "cuda" service and none by the "lax" one;
    - service_flagship: the flagship's 1,000,000 queued jobs on 50,000
      nodes, one "cuda" service, 1 cold and FLAGSHIP_SERVICE_WARM_CYCLES
      warm cycles, the same checks;
    - sim_differential: the JAX package's differential simulation
      (workload.sim_workload, seed 0) through the port's Simulator on the
      card: the kernel history equal to the oracle's with no failover
      and both fill kernels launched; then a kernel run with one
      solver_raise injected on local:cuda (SolverChaos), the card's one
      rung: that round is rejected with its cause recorded and re-solved
      on local:cuda a cycle later, never on "lax" or the host, and the
      history is that of an oracle run with the same fault on its one
      rung."""
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.services.chaos import FaultPlan, FaultSpec
    from armada_tpu_torch.sim import Simulator
    from armada_tpu_torch.workload import sim_history, sim_workload, submit_events

    rec = {}
    t0 = time.time()
    cfg, entries, submit_s = submit_events(100_000)
    svc = {"submit_us_per_job": submit_s / 100_000 * 1e6, "build_submit_s": time.time() - t0}
    hist = {}
    for kp in ("cuda", "lax"):
        summary, hist[kp] = _service_run(cfg, entries, 5000, kp, 1 + SERVICE_WARM_CYCLES,
                                         f"service_100k/{kp}")
        summary["ingest_us_per_job"] = summary["ingest_s"] / 100_000 * 1e6
        svc[kp] = summary
    if hist["cuda"] != hist["lax"]:
        raise AssertionError("service_100k: the cuda and lax services leased differently")
    svc["cuda_equals_lax"] = True
    require_fill_launches(svc["cuda"]["launches"], "service_100k/cuda")
    if any(svc["lax"]["launches"][k] for k in K.KERNELS):
        raise AssertionError(f"service_100k: the lax service launched {svc['lax']['launches']}")
    rec["service_100k"] = svc
    del entries

    t0 = time.time()
    cfg, entries, submit_s = submit_events(1_000_000)
    flag = {"submit_us_per_job": submit_s / 1_000_000 * 1e6, "build_submit_s": time.time() - t0}
    summary, _ = _service_run(cfg, entries, 50_000, "cuda", 1 + FLAGSHIP_SERVICE_WARM_CYCLES,
                              "service_flagship")
    summary["ingest_us_per_job"] = summary["ingest_s"] / 1_000_000 * 1e6
    flag.update(summary)
    require_fill_launches(flag["launches"], "service_flagship")
    rec["service_flagship"] = flag
    del entries

    t0 = time.time()
    clusters, spec, cfg = sim_workload()
    sims = {}
    runs = (("oracle", None), ("kernel", None),
            ("kernel_fault", FaultPlan([FaultSpec("solver_raise", "local:cuda", count=1)])),
            ("oracle_fault", FaultPlan([FaultSpec("solver_raise", "oracle", count=1)])))
    for name, plan in runs:
        K.reset_launches()
        sim = Simulator(clusters, spec, config=cfg, backend=name.split("_")[0], seed=0,
                        max_time=5000.0, fault_plan=plan)
        t1 = time.time()
        res = sim.run()
        sims[name] = {"history": sim_history(res), "seconds": time.time() - t1,
                      "cycles": res.cycles, "finished": res.finished_jobs,
                      "launches": dict(K.LAUNCHES),
                      "ladder": [r.label for r in sim.scheduler._rungs],
                      "failovers": [(f["from"], f["to"], f["cause"])
                                    for f in sim.scheduler.recent_failovers]}
    for name, want in (("kernel", "oracle"), ("kernel_fault", "oracle_fault")):
        if sims[name]["history"] != sims[want]["history"]:
            raise AssertionError(f"sim_differential: the {name} history is not the {want} one")
        require_fill_launches(sims[name]["launches"], f"sim_differential/{name}")
        if sims[name]["ladder"] != ["local:cuda"]:
            raise AssertionError(f"sim_differential: the card's ladder is {sims[name]['ladder']}")
    if sims["kernel"]["failovers"] or sims["oracle"]["failovers"]:
        raise AssertionError(f"sim_differential: failovers {sims['kernel']['failovers']}")
    for name, rung in (("kernel_fault", "local:cuda"), ("oracle_fault", "oracle")):
        if sims[name]["failovers"] != [(rung, "rejected", "raise")]:
            raise AssertionError(f"sim_differential: the {name} run's failovers were "
                                 f"{sims[name]['failovers']}")
    for s in sims.values():
        s.pop("history")
    rec["sim_differential"] = {**sims, "kernel_equals_oracle": True,
                               "kernel_fault_equals_oracle_fault": True,
                               "seconds": time.time() - t0}
    return rec


OBSERVATORY_CYCLES = 3  # 1 cold and 2 warm, in the recorded and market services
MARKET_SERVICE_NODES, MARKET_SERVICE_JOBS = 128, 8192  # market_round(128, 8192)
FIXTURE = os.path.join(HERE, "tests", "fixtures", "sim_steady.atrace")


def _replay(path, solvers, label, **kw):
    """replay_trace of one bundle on the card with the compile delta of
    the whole replay; zero divergences of any class required."""
    from armada_tpu_torch.observe.compiles import TELEMETRY
    from armada_tpu_torch.trace import load_trace, replay_trace

    t0 = time.time()
    trace = load_trace(path)
    comp0 = TELEMETRY.thread_snapshot()
    report = replay_trace(trace, solvers=solvers, **kw)
    compiles = TELEMETRY.delta_since(comp0, thread=True)
    if not report["ok"] or report["divergences"]:
        bad = [r for r in report["results"] if r["divergences"]][:3]
        raise AssertionError(f"{label}: replay diverged {report['divergences']}: {bad}")
    return {"rounds": report["rounds"], "skipped": report["skipped"], "solvers": list(solvers),
            "replay_s": [r["replay_s"] for r in report["results"]], "compiles": compiles,
            "seconds": time.time() - t0}


def phase_observatory(tmp):
    """The round observatory and the market pool's post-round seams on
    the card, bundles under `tmp`:
    - fixture_replay: the committed bundle the JAX package recorded
      (tests/fixtures/sim_steady.atrace: 6 rounds, x64, fill window 2)
      replayed by the port's replayer under LOCAL (the "cuda" path), "lax"
      and hotwindow:64 (compacted, on "cuda") with allow_foreign, one
      replay each: zero divergences of any class, both fill kernels
      launched by LOCAL and by hotwindow:64, none by "lax";
    - recorded_service: phase 12's service_100k "cuda" service with a
      TraceRecorder, the metrics registry (None without
      prometheus_client) and an SLOTracker attached, 1 cold and 2 warm
      cycles: the bundle holds every round; no kernel library built or
      loaded in a warm cycle; the bundle replays under LOCAL and "lax"
      with zero divergences (a build on a replayed shape would be a
      `retrace` one) and no build or load; bytes and recording seconds a
      round, alloc_segments a cycle, the SLO burn rates;
    - market_service: workload.MarketServiceRun (market_round(128,
      8192)'s jobs submitted through the SubmitService, two executors of
      64 nodes of 16 cpu / 64Gi, the optimiser on, two gang shapes priced,
      band B's bid raised after the second fetch) on the "kernel" backend
      ("cuda") and on the host oracle, an independent solver, 1 cold and
      2 warm cycles each: equal leases, preemptions, spot prices,
      indicative prices (none timed out), idealised and realised values
      cycle by cycle, and the third cycle's bid refresh re-prices jobs;
    - postmortem: phase 12's kernel simulation with one solver_raise on
      local:cuda, with a TraceRecorder attached: the rejected round leaves
      a single-round postmortem bundle in the quarantine directory,
      which replays on "cuda" with zero divergences (a raised solve has no
      decision stream; the replayed solve passes the round firewall on
      the bundle's own round), and the run's bundle replays on LOCAL.
    Launch counts are set to 0 before each run and read after it."""
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.services.chaos import FaultPlan, FaultSpec
    from armada_tpu_torch.services.metrics import SchedulerMetrics
    from armada_tpu_torch.services.slo import SLOTracker
    from armada_tpu_torch.sim import Simulator
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.validate import validate_round
    from armada_tpu_torch.trace import TraceRecorder, load_trace
    from armada_tpu_torch.workload import (
        MarketServiceRun,
        ServiceRun,
        sim_workload,
        submit_events,
    )

    rec = {}
    launches = {name: 0 for name in K.KERNELS}

    def count(label, required=()):
        got = dict(K.LAUNCHES)
        for name in launches:
            launches[name] += got[name]
        for name in required:
            if not got[name]:
                raise AssertionError(f"{label}: {name} was not launched ({got})")
        return got

    t0 = time.time()
    fixture = {}
    for solver in ("LOCAL", "lax", "hotwindow:64"):
        K.reset_launches()
        label = f"fixture_replay {solver}"
        fixture[solver] = _replay(FIXTURE, (solver,), label, allow_foreign=True)
        fixture[solver]["launches"] = count(
            label, () if solver == "lax" else FILL_KERNELS)
        if solver == "lax" and any(fixture[solver]["launches"].values()):
            raise AssertionError(f"{label}: the lax path launched a kernel")
    fixture["seconds"] = time.time() - t0
    rec["fixture_replay"] = fixture

    t0 = time.time()
    cfg, entries, _ = submit_events(100_000)
    path = os.path.join(tmp, "service_100k.atrace")
    K.reset_launches()
    run = ServiceRun(cfg, entries, 5000, kernel_path="cuda")
    del entries
    recorder = TraceRecorder(path, source="scheduler", config=run.sched.config)
    record_s, record_bytes = [], []
    record_round = recorder.record_round

    def timed_record(**kw):
        t1, b1 = time.perf_counter(), recorder.bytes_written
        out = record_round(**kw)
        record_s.append(time.perf_counter() - t1)
        record_bytes.append(recorder.bytes_written - b1)
        return out

    recorder.record_round = timed_record
    run.sched.attach_trace_recorder(recorder)
    run.sched.attach_metrics(SchedulerMetrics())
    slo = SLOTracker()
    run.sched.attach_slo(slo)
    cycles = []
    for i in range(OBSERVATORY_CYCLES):
        r = run.cycle()
        st = r["stats"]
        if st["rung"] != "local:cuda" or st["failover"] is not None or not r["leases"]:
            raise AssertionError(f"recorded_service cycle {i}: {st['rung']}, {st['failover']}")
        if i:
            _require_warm(st["compiles"], f"recorded_service cycle {i}")
        cycles.append({"leased": len(r["leases"]), "cycle_s": r["cycle_s"],
                       "solve_s": st["solve_s"], "compiles": st["compiles"]})
    service_launches = count("recorded_service", FILL_KERNELS)
    recorder.close()
    if recorder.rounds_recorded != OBSERVATORY_CYCLES or len(record_s) != OBSERVATORY_CYCLES:
        raise AssertionError(f"recorded_service: {recorder.rounds_recorded} rounds recorded "
                             f"of {OBSERVATORY_CYCLES}")
    if len(load_trace(path).rounds) != OBSERVATORY_CYCLES:
        raise AssertionError("recorded_service: the bundle does not hold every round")
    now = run.now
    slo_doc = slo.snapshot(now=now)
    del run
    K.reset_launches()
    replay = _replay(path, ("LOCAL", "lax"), "recorded_service replay")
    _require_warm(replay["compiles"], "recorded_service replay")
    replay["launches"] = count("recorded_service replay", FILL_KERNELS)
    rec["recorded_service"] = {
        "cycles": cycles, "launches": service_launches,
        "bundle_bytes": os.path.getsize(path), "bytes_per_round": record_bytes,
        "record_s_per_round": record_s, "replay": replay,
        "slo": {s["name"]: {"observed": s["observed"], "compliance": s["compliance"],
                            "burn": s.get("burn")} for s in slo_doc["slos"]},
        "seconds": time.time() - t0,
    }

    t0 = time.time()
    hist, market = {}, {}
    for backend, rung in (("kernel", "local:cuda"), ("oracle", "oracle")):
        K.reset_launches()
        t1 = time.time()
        run = MarketServiceRun(MARKET_SERVICE_NODES, MARKET_SERVICE_JOBS, backend=backend,
                               kernel_path="cuda")
        recs = [run.cycle() for _ in range(OBSERVATORY_CYCLES)]
        label = f"market_service/{backend}"
        for i, r in enumerate(recs):
            st = r["stats"]
            if st["rung"] != rung or st["failover"]:
                raise AssertionError(f"{label} cycle {i}: {st['rung']}")
            if not all(s["evaluated"] for s in r["market"]["indicative"].values()):
                raise AssertionError(f"{label} cycle {i}: a gang shape timed out")
            if i and backend == "kernel":
                _require_warm(st["compiles"], f"{label} cycle {i}")
        if not recs[0]["leases"] or recs[-1]["market"]["repriced"] <= 0:
            raise AssertionError(f"{label}: leased {len(recs[0]['leases'])}, "
                                 f"re-priced {recs[-1]['market']['repriced']}")
        hist[backend] = [(r["leases"], r["preempted"], r["market"]) for r in recs]
        market[backend] = {
            "submit_s": run.submit_s, "launches": count(label),
            "cycles": [{"leased": len(r["leases"]), "preempted": len(r["preempted"]),
                        "cycle_s": r["cycle_s"], "solve_s": r["stats"]["solve_s"],
                        "post_round_s": r["stats"]["post_round_s"], **r["market"]}
                       for r in recs],
            "seconds": time.time() - t1,
        }
        del run
    if hist["kernel"] != hist["oracle"]:
        raise AssertionError("market_service: the card's service and the host oracle's differ")
    market["kernel_equals_oracle"] = True
    market["seconds"] = time.time() - t0
    rec["market_service"] = market

    t0 = time.time()
    clusters, spec, cfg = sim_workload()
    K.reset_launches()
    sim = Simulator(clusters, spec, config=cfg, backend="kernel", seed=0, max_time=5000.0,
                    fault_plan=FaultPlan([FaultSpec("solver_raise", "local:cuda", count=1)]),
                    trace_path=os.path.join(tmp, "sim_fault.atrace"))
    sim.scheduler.quarantine_dir = os.path.join(tmp, "quarantine")
    res = sim.run()
    failovers = list(sim.scheduler.recent_failovers)
    if [(f["from"], f["to"], f["cause"]) for f in failovers] != [("local:cuda", "rejected", "raise")]:
        raise AssertionError(f"postmortem: failovers {failovers}")
    bundle = failovers[0].get("bundle")
    if not bundle or not os.path.exists(bundle):
        raise AssertionError("postmortem: the rejected round left no bundle")
    sim_launches = count("postmortem simulation", FILL_KERNELS)
    (round_,) = load_trace(bundle).rounds
    pm_replay = _replay(bundle, ("cuda",), "postmortem replay")
    dev = round_.device_round()
    out = solve_round(dev)
    violation = validate_round(out, dev=dev)
    if violation is not None:
        raise AssertionError(f"postmortem: the replayed round is rejected: {violation}")
    sim_replay = _replay(os.path.join(tmp, "sim_fault.atrace"), ("LOCAL",), "postmortem sim replay")
    count("postmortem replays")
    rec["postmortem"] = {
        "finished": res.finished_jobs, "cycles": res.cycles, "launches": sim_launches,
        "bundle": os.path.basename(bundle), "bundle_bytes": os.path.getsize(bundle),
        "bundle_jobs": round_.num_jobs, "replay": pm_replay,
        "replayed_scheduled": int(out["scheduled_mask"].sum()), "sim_replay": sim_replay,
        "seconds": time.time() - t0,
    }
    rec["launches"] = launches
    return rec


AUTOTUNE_CYCLES = 3  # 1 cold and 2 warm, in the recorded and the tuned service
AUTOTUNE_JOBS, AUTOTUNE_NODES = 100_000, 5000  # service_100k's width
# The corpus's hot window: 10 queues pad to 16, and a window compacts
# where 2 x 16 x Ws < 131,072 rows, so 2,048 is the widest that does (and
# the fill window's lookahead of 2,048 the narrowest Ws).
AUTOTUNE_HOT_WINDOW = 2048
AUTOTUNE_WINDOWS = (1024, 4096, 16384)  # the offline grid, each with no floor
# Service B's tuned window, the grid's narrowest, which compacts at this
# width whatever the offline timing selects.
ONLINE_WINDOW = 1024
BURST_PLANS, BURST_CYCLES = 6, 3  # whatif_isolation: plans fired, live cycles meanwhile


def phase_autotune_whatif(tmp):
    """Autotune and the what-if planner beside the live round (phase 14),
    at service_100k's width: AUTOTUNE_JOBS queued jobs in 10 queues on two
    executors of AUTOTUNE_NODES / 2 nodes, the bench's config (fast fill,
    window 2,048) with the hot window at AUTOTUNE_HOT_WINDOW slots and no
    floor, so that compaction engages at 131,072 rows; the "kernel"
    backend, whose one rung on the card is local:cuda:
    - autotune_offline: service A (no controller) records its 1 cold and
      2 warm cycles with a TraceRecorder, every round compacted;
      `tune_corpus` re-solves the bundle's rounds on "cuda" at the
      baseline (the bundle's 2,048) and at windows 1,024, 4,096 and
      16,384 (the last two fused: they do not engage), no floor, one
      timed pass each: every candidate bit-exact with the recording and
      launching both fill kernels and the segment kernel; each timed
      pass ends in the last solve's decision readback (solve_round's
      copy of the decisions to the host), a synchronise. The selected
      entry goes into a TuningStore, through CheckpointStore.save, and
      back through load;
    - autotune_online: service B, fed the same events, seeded from a
      store holding the same entry at ONLINE_WINDOW (kept apart from the
      timing-dependent selection, so the tuned rounds compact), also
      through the checkpoint, with an AutotuneController attached and a
      recorder, 1 cold and 2 warm cycles: every recorded round's solver
      info says autotuned with that window and its profile compacted,
      and the leases after every cycle are A's (tuning changes speed,
      never decisions); the controller's adoptions and its gauges'
      values;
    - whatif_plan: a WhatIfService(workers=1) on A: plan_drain of
      executor-0 (deadline one cycle), a plan injecting a gang of 8 jobs
      of 4 cpu in a new queue (2 rounds; it starts in the first), and
      parity_check of the committed fixture
      fork under LOCAL (zero divergences); the rollouts, in the
      planner's rollout process, launch both fill kernels there. Then
      the drain runs on A (and the same drain on B, its
      twin) for as many cycles as the plan's rollout ran: its outcome
      (completed, preempted, blocked, landings, rounds to drain) is the
      plan's, and A's leases are B's every cycle;
    - whatif_isolation: BURST_PLANS plans fired at once on threads at a
      1-worker, 2-deep planner over A while A and B run BURST_CYCLES
      live cycles: some are shed with WhatIfBusyError, the admitted ones
      finish, A's leases equal B's (no planner) after every cycle, and
      no A cycle builds or loads a kernel library (the rollouts run in
      the planner's rollout process). Phase 15 holds a budgeted service
      beside plans.
    Launch counts are set to 0 before each part and read after it; the
    rollouts' are counted in their process and returned with the plans."""
    import dataclasses
    import threading

    from armada_tpu_torch.autotune import (
        AutotuneController,
        TunedParams,
        TuningStore,
        default_grid,
        make_entry,
        tune_corpus,
    )
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.services.checkpoint import CheckpointStore
    from armada_tpu_torch.trace import TraceRecorder, load_trace
    from armada_tpu_torch.whatif import (
        WhatIfBusyError,
        WhatIfService,
        fork_from_trace,
        mutations_from_dicts,
    )
    from armada_tpu_torch.whatif.planner import parity_check
    from armada_tpu_torch.workload import ServiceRun, submit_events

    rec, launches = {}, {name: 0 for name in K.KERNELS}

    def rollout_launches(wi, n):
        """The launch counts of the planner's last `n` rollouts."""
        return [s["launches"] for s in list(wi.plan_stats)[-n:]]

    def live_cycle(run, label):
        """One live cycle as the planner's rollouts run theirs: the
        executors tick, the service cycles, the executors tick again."""
        out = run.cycle()
        for ex in run.executors:
            ex.tick(run.now - run.interval)
        st = out["stats"]
        if st["failover"] is not None or st["rung"] != "local:cuda":
            raise AssertionError(f"{label}: rung {st['rung']}, failover {st['failover']}")
        return out

    t0 = time.time()
    base_cfg, entries, _ = submit_events(AUTOTUNE_JOBS)
    cfg = dataclasses.replace(base_cfg, hot_window_slots=AUTOTUNE_HOT_WINDOW,
                              hot_window_min_slots=0)
    path = os.path.join(tmp, "autotune.atrace")
    K.reset_launches()
    a = ServiceRun(cfg, entries, AUTOTUNE_NODES, kernel_path="cuda")
    recorder = TraceRecorder(path, source="scheduler", config=a.sched.config)
    a.sched.attach_trace_recorder(recorder)
    a_leases = [live_cycle(a, f"service A cycle {i}")["leases"] for i in range(AUTOTUNE_CYCLES)]
    a.sched.trace_recorder = None
    recorder.close()
    corpus = load_trace(path)
    if len(corpus.rounds) != AUTOTUNE_CYCLES or not all(
            (r.raw.get("profile") or {}).get("compacted") for r in corpus.rounds):
        raise AssertionError("autotune_offline: the corpus's rounds are not all compacted")
    record_launches = take_launches(launches, "autotune_offline: the recorded service")
    t1 = time.time()
    per_candidate = {}

    def note(line):
        label = line.split(":")[0]
        if label in ("baseline",) or label.startswith("w"):
            per_candidate[label] = take_launches(launches,
                                                 f"autotune_offline: candidate {label}")

    report = tune_corpus([corpus], default_grid(windows=AUTOTUNE_WINDOWS, min_slots=(0,)),
                         repeats=1, log=note)
    if not report["ok"] or not all(r["bit_exact"] for r in report["results"]):
        raise AssertionError(f"autotune_offline: a candidate diverged {report['results']}")
    if sorted(per_candidate) != sorted(r["label"] for r in report["results"]):
        raise AssertionError(f"autotune_offline: candidates {sorted(per_candidate)}")
    sel = report["selected"]
    (at_online,) = [r for r in report["results"]
                    if r["params"]["hot_window_slots"] == ONLINE_WINDOW]
    online = make_entry(TunedParams(ONLINE_WINDOW), target=sel["target"],
                        workload=sel["workload"], pool=sel["pool"],
                        baseline_s=sel["baseline_s"], tuned_s=at_online["wall_s"],
                        meta={"label": at_online["label"]})
    ckpt = CheckpointStore(os.path.join(tmp, "ckpt"))
    stores = {}
    for name, entry in (("autotune", report["selected"]), ("autotune_online", online)):
        store = TuningStore()
        store.put(entry)
        ckpt.save(name, 0, store.dump())
        stores[name] = TuningStore()
        stores[name].load(ckpt.load(name)[1])
        if stores[name].dump() != store.dump():
            raise AssertionError(f"autotune_offline: the {name} store did not survive its checkpoint")
    window = report["selected"]["params"]["hot_window_slots"]
    rec["autotune_offline"] = {
        "rounds": report["rounds"], "workload": report["workload"],
        "results": [{"label": r["label"], "bit_exact": r["bit_exact"], "wall_s": r["wall_s"],
                     "launches": per_candidate[r["label"]]} for r in report["results"]],
        "selected": report["selected"]["meta"]["label"], "window": window,
        "record_launches": record_launches, "tune_s": time.time() - t1,
        "seconds": time.time() - t0,
    }

    t0 = time.time()
    ctl = AutotuneController(dataclasses.replace(cfg, autotune_enabled=True),
                             store=stores["autotune_online"])
    b = ServiceRun(cfg, entries, AUTOTUNE_NODES, kernel_path="cuda")
    del entries
    b.sched.attach_autotune(ctl)
    path_b = os.path.join(tmp, "tuned.atrace")
    b.sched.attach_trace_recorder(TraceRecorder(path_b, source="scheduler", config=b.sched.config))
    for i, want in enumerate(a_leases):
        if live_cycle(b, f"service B cycle {i}")["leases"] != want:
            raise AssertionError(f"autotune_online cycle {i}: the tuned leases differ from A's")
    b.sched.trace_recorder.close()
    b.sched.trace_recorder = None
    tuned = load_trace(path_b).rounds
    solver = [r.raw["solver"] for r in tuned]
    if len(solver) != AUTOTUNE_CYCLES or not all(
            s["autotuned"] and s["window"] == ONLINE_WINDOW for s in solver):
        raise AssertionError(f"autotune_online: recorded solver info {solver}")
    if not all((r.raw.get("profile") or {}).get("compacted") for r in tuned):
        raise AssertionError("autotune_online: a tuned round did not run compacted")
    params = ctl.params_for("default")
    rec["autotune_online"] = {
        "cycles": AUTOTUNE_CYCLES, "window": ONLINE_WINDOW, "compacted": True,
        "equal_to_untuned": True,
        "adoptions": [{k: v for k, v in x.items() if k != "ts"} for x in ctl.adoptions],
        "gauges": {"scheduler_autotune_window_slots": params.hot_window_slots,
                   "scheduler_autotune_chunk_loops": params.chunk_loops,
                   "scheduler_autotune_store_entries": len(ctl.store)},
        "launches": take_launches(launches, "autotune_online"), "seconds": time.time() - t0,
    }

    t0 = time.time()
    wi = WhatIfService(a.sched, workers=1)
    a.sched.attach_whatif(wi)
    remaining = {jid: run.finishes_at - a.now
                 for ex in a.executors for jid, run in ex.active.items()}
    K.reset_launches()
    drain = wi.plan_drain("executor-0", deadline_s=a.interval, rounds=3, runtime_for=remaining)
    drain_launches = take_launches(launches, "whatif_plan: the drain plan's rollout",
                                   rollout_launches(wi, 1))
    gang = wi.plan(mutations_from_dicts([{"kind": "inject_gang", "queue": "whatif",
                                          "gang_cardinality": 8, "cpu": "4",
                                          "memory": "8Gi"}]), rounds=2)
    gang_launches = take_launches(launches, "whatif_plan: the inject-gang rollout",
                                  rollout_launches(wi, 1))
    parity = parity_check(fork_from_trace(FIXTURE, 0, allow_foreign=True), "LOCAL")
    parity_launches = take_launches(launches, "whatif_plan: the parity check")
    if not parity["ok"]:
        raise AssertionError(f"whatif_plan: parity diverged {parity['divergences']}")
    (injected,) = gang.injected
    if injected["eta_rounds"] is None:
        raise AssertionError(f"whatif_plan: the injected gang did not start {injected}")
    pred = drain.drain
    if not pred["preempted"]:
        raise AssertionError(f"whatif_plan: the drain plan preempted nothing {pred}")
    plans_s = time.time() - t0
    wi.execute_drain("executor-0", deadline_s=a.interval)
    b.sched.drains.start("executor-0", deadline_s=b.interval)
    for i in range(drain.rounds_simulated):
        got = live_cycle(a, f"drain cycle {i}")["leases"]
        if got != live_cycle(b, f"twin drain cycle {i}")["leases"]:
            raise AssertionError(f"whatif_plan: drain cycle {i} leased differently on A and B")
    actual = wi.drain_status("executor-0")
    for key in ("completed", "preempted", "blocked", "landings", "rounds_to_drain"):
        if pred[key] != actual[key]:
            raise AssertionError(f"whatif_plan: the drain's {key} was {actual[key]}, "
                                 f"the plan's {pred[key]}")
    rec["whatif_plan"] = {
        "drain": {"plan_s": drain.plan_seconds, "rounds_simulated": drain.rounds_simulated,
                  "displaced": len(drain.displaced),
                  "landed": sum(d["landed_node"] is not None for d in drain.displaced),
                  "preempted": len(pred["preempted"]), "landings": len(pred["landings"]),
                  "rounds_to_drain": pred["rounds_to_drain"], "done": pred["done"],
                  "equals_execute_drain": True, "launches": drain_launches},
        "inject_gang": {"plan_s": gang.plan_seconds, "eta_rounds": injected["eta_rounds"],
                        "nodes": len(injected["nodes"]), "feasible": injected["feasible"],
                        "launches": gang_launches},
        "parity": {"ok": parity["ok"], "solve_s": parity["solve_s"],
                   "num_jobs": parity["num_jobs"], "launches": parity_launches},
        "plans_s": plans_s,
        "drain_cycles_launches": take_launches(launches, "whatif_plan: the drain cycles"),
        "seconds": time.time() - t0,
    }

    t0 = time.time()
    burst = WhatIfService(a.sched, workers=1, queue_depth=2)
    a.sched.attach_whatif(burst)
    plans, shed = [], []

    def fire():
        try:
            plans.append(burst.plan(mutations_from_dicts(
                [{"kind": "inject_gang", "queue": "queue-01", "gang_cardinality": 2,
                  "cpu": "1"}]), rounds=1))
        except WhatIfBusyError as e:
            shed.append(str(e))

    threads = [threading.Thread(target=fire) for _ in range(BURST_PLANS)]
    for th in threads:
        th.start()
    live = []
    for i in range(BURST_CYCLES):
        out = live_cycle(a, f"isolation cycle {i}")
        if out["leases"] != live_cycle(b, f"isolation twin cycle {i}")["leases"]:
            raise AssertionError(f"whatif_isolation cycle {i}: A's leases are not B's")
        _require_warm(out["stats"]["compiles"], f"whatif_isolation cycle {i}")
        live.append({"leased": len(out["leases"]), "cycle_s": out["cycle_s"],
                     "solve_s": out["stats"]["solve_s"], "compiles": out["stats"]["compiles"]})
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads):
        raise AssertionError("whatif_isolation: a plan did not finish")
    if not shed or not plans or burst._pending:
        raise AssertionError(f"whatif_isolation: {len(plans)} planned, {len(shed)} shed, "
                             f"{burst._pending} pending")
    rec["whatif_isolation"] = {
        "fired": BURST_PLANS, "planned": len(plans), "shed": len(shed),
        "plan_s": [p.plan_seconds for p in plans], "live_cycles": live,
        "live_equals_no_planner": True,
        "launches": take_launches(launches, "whatif_isolation",
                                  rollout_launches(burst, len(plans))),
        "plan_stats": plan_costs(burst.plan_stats),
        "seconds": time.time() - t0,
    }
    wi.close()
    burst.close()
    rec["launches"] = launches
    return rec


PERSIST_JOBS, PERSIST_NODES = 100_000, 5000  # service_100k's width
PERSIST_BUDGET_S = 5.0  # every phase 15 service's round budget, Armada's maxSchedulingDuration
PERSIST_CYCLES, RESTART_CYCLES = 3, 2  # file_log_service: before and after its restart
FRONTDOOR_SHARDS, FRONTDOOR_CYCLES = 3, 2
SOAK_SEED, SOAK_JOBS = 0, 24  # run_plan and run_solver_plan, each run twice
ISOLATION_PLANS = 2  # whatif_isolation: 100k-job rollouts at once, one rollout process each
ISOLATION_WAVES = 2  # the second on rollout processes that hold the fork's specs
ISOLATION_MIN_CYCLES = 3  # live cycles beside each wave's rollouts, at least
ISOLATION_MAX_RATIO = 1.5  # median live cycle beside the rollouts over the median alone


def phase_persistence(tmp, n_jobs=PERSIST_JOBS, n_nodes=PERSIST_NODES, device=None):
    """Persistence, the front door and the what-if planner's rollout
    processes on the card (phase 15). Every service runs service_100k's
    width (n_jobs queued jobs in 10 queues, two executors of n_nodes / 2
    nodes, the bench's config: fast fill, window 2,048) with a round
    budget of PERSIST_BUDGET_S, on the kernel backend, whose one rung on
    the card is local:cuda (score_nodes, fill_take and segment_add). A
    twin service over an in-memory log runs PERSIST_CYCLES +
    RESTART_CYCLES cycles uninterrupted; the others are held to its
    leases cycle by cycle:
    - file_log_service: the same service over a FileEventLog in `tmp`,
      PERSIST_CYCLES cycles, then a restart (the log closed and a new one
      opened on the directory, a new SchedulerService whose job database
      is rebuilt from it) and RESTART_CYCLES more. Prints the bytes on
      disk, the publish microseconds a job, the recovery seconds and the
      cycles' seconds after the restart;
    - soak: `tools.chaos_soak.run_plan(SOAK_SEED, "kernel", SOAK_JOBS)`
      (crashes, hangs, lease faults, leader flaps, partitions, torn
      tails on the real file log) and `run_solver_plan(SOAK_SEED,
      SOAK_JOBS)` (every solver fault contained, every rejection's
      bundle replaying DIVERGED), each run twice: equal digests, every
      job finished;
    - frontdoor_service: the same jobs submitted through a
      SubmitService with a FrontDoor of FRONTDOOR_SHARDS shards, pumped
      until delivered, then FRONTDOOR_CYCLES cycles: the leases of direct
      publish. Prints the submit and pump seconds and the highest
      max_lag;
    - whatif_isolation: a planner (WhatIfService, ISOLATION_PLANS
      workers) on a fresh service, whose cycles are first held to the
      twin's alone, then ISOLATION_WAVES waves of ISOLATION_PLANS
      inject-gang plans fired at once on threads: their rollouts (each a
      100k-job service seeded from the fork) run in rollout processes on
      the card while the service and the twin go on cycling in step (at
      least ISOLATION_MIN_CYCLES a wave), its leases the twin's after
      every cycle, no kernel built in a live cycle, no round truncated by
      its budget, the median live cycle beside the rollouts at most
      ISOLATION_MAX_RATIO times the median alone. The second wave runs
      on the processes of the first, which hold the fork's specs: each
      of its plans must send under a tenth of them. Prints each live
      cycle's seconds (and its solve's) alone and beside the rollouts,
      their medians and ratio, the slowest cycle beside them against the
      budget, and what each plan cost the live process (`plan_stats`).
    Launch counts are set to 0 before each part and read after it; the
    rollouts' are counted in their processes and returned with the
    plans."""
    import dataclasses
    import statistics
    import threading

    from armada_tpu_torch.events import FileEventLog
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.tools.chaos_soak import run_plan, run_solver_plan
    from armada_tpu_torch.whatif import WhatIfService, mutations_from_dicts
    from armada_tpu_torch.workload import ServiceRun, front_door_events, submit_events

    rec, launches = {}, {name: 0 for name in K.KERNELS}

    def cycle(run, label):
        out = run.cycle()
        st = out["stats"]
        if st["failover"] is not None or st["rung"] != "local:cuda":
            raise AssertionError(f"{label}: rung {st['rung']}, failover {st['failover']}")
        if st.get("truncated"):
            raise AssertionError(f"{label}: the round was cut by its {PERSIST_BUDGET_S} s budget")
        return out

    def held(got, want, label):
        if got["leases"] != want["leases"] or got["preempted"] != want["preempted"]:
            raise AssertionError(f"{label}: the leases are not the twin's")

    t0 = time.time()
    base, entries, submit_s = submit_events(n_jobs)
    cfg = dataclasses.replace(base, max_scheduling_duration_s=PERSIST_BUDGET_S)
    K.reset_launches()
    twin = ServiceRun(cfg, entries, n_nodes, device=device)
    want = [cycle(twin, f"twin cycle {i}") for i in range(PERSIST_CYCLES + RESTART_CYCLES)]
    rec["twin"] = {"submit_us_per_job": submit_s / n_jobs * 1e6,
                   "cycle_s": [w["cycle_s"] for w in want],
                   "leased": [len(w["leases"]) for w in want],
                   "launches": take_launches(launches, "persistence: the twin"),
                   "seconds": time.time() - t0}

    t0 = time.time()
    path = os.path.join(tmp, "log")
    log = FileEventLog(path)
    f = ServiceRun(cfg, entries, n_nodes, device=device, log=log)
    got = [cycle(f, f"file_log_service cycle {i}") for i in range(PERSIST_CYCLES)]
    log.close()
    on_disk = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
    t1 = time.perf_counter()
    log = FileEventLog(path)
    open_s = time.perf_counter() - t1
    rebuild_s = f.restart(log)
    if len(f.sched.jobdb) != n_jobs:
        raise AssertionError(f"file_log_service: the restarted job database holds "
                             f"{len(f.sched.jobdb)} jobs")
    got += [cycle(f, f"file_log_service cycle {PERSIST_CYCLES + i} (restarted)")
            for i in range(RESTART_CYCLES)]
    for i, (g, w) in enumerate(zip(got, want)):
        held(g, w, f"file_log_service cycle {i}")
    log.close()
    rec["file_log_service"] = {
        "records": log.end_offset, "bytes_on_disk": on_disk,
        "publish_us_per_job": f.publish_s / n_jobs * 1e6, "ingest_s": f.ingest_s,
        "recovery_s": open_s + rebuild_s, "log_open_s": open_s, "rebuild_s": rebuild_s,
        "cycle_s": [g["cycle_s"] for g in got[:PERSIST_CYCLES]],
        "cycle_s_after_restart": [g["cycle_s"] for g in got[PERSIST_CYCLES:]],
        "equals_in_memory_twin": True,
        "launches": take_launches(launches, "file_log_service"), "seconds": time.time() - t0,
    }
    del f, got

    t0 = time.time()
    plans = [run_plan(SOAK_SEED, "kernel", SOAK_JOBS, device=device) for _ in range(2)]
    solver = [run_solver_plan(SOAK_SEED, SOAK_JOBS, replay=i == 0, device=device)
              for i in range(2)]
    for name, (a, b) in (("run_plan", plans), ("run_solver_plan", solver)):
        if a["digest"] != b["digest"] or a["finished"] != a["total"]:
            raise AssertionError(f"soak: {name} digests {a['digest'][:12]} {b['digest'][:12]}, "
                                 f"{a['finished']} of {a['total']} finished")
    if not plans[0]["log_crashes"]:
        raise AssertionError("soak: no torn write crashed the file log")
    rec["soak"] = {
        "run_plan": {k: plans[0][k] for k in ("finished", "total", "cycles", "faults_fired",
                                               "log_crashes", "anti_entropy")},
        "run_solver_plan": {"finished": solver[0]["finished"], "cycles": solver[0]["cycles"],
                            "injected": solver[0]["injected"],
                            "rejections": len(solver[0]["rejections"]),
                            "bundles_replayed": solver[0]["bundles_replayed"],
                            "failover_causes": sorted({x["cause"] for x in solver[0]["failovers"]})},
        "deterministic": True,
        "launches": take_launches(launches, "soak"), "seconds": time.time() - t0,
    }

    t0 = time.time()
    _, fd_log, fd = front_door_events(n_jobs, FRONTDOOR_SHARDS)
    d = ServiceRun(cfg, (), n_nodes, device=device, log=fd_log)
    for i in range(FRONTDOOR_CYCLES):
        held(cycle(d, f"frontdoor_service cycle {i}"), want[i], f"frontdoor_service cycle {i}")
    rec["frontdoor_service"] = {
        "shards": FRONTDOOR_SHARDS, "submit_us_per_job": fd["submit_s"] / n_jobs * 1e6,
        "pump_s": fd["pump_s"], "pumps": fd["pumps"], "max_lag": fd["max_lag"],
        "ingest_s": d.ingest_s, "cycles": FRONTDOOR_CYCLES, "equals_direct_publish": True,
        "launches": take_launches(launches, "frontdoor_service"), "seconds": time.time() - t0,
    }
    del d, fd_log

    t0 = time.time()
    w = ServiceRun(cfg, entries, n_nodes, device=device)
    del entries
    wi = WhatIfService(w.sched, workers=ISOLATION_PLANS, queue_depth=ISOLATION_PLANS)
    w.sched.attach_whatif(wi)
    alone = []
    for i, want_i in enumerate(want):
        out = cycle(w, f"whatif_isolation cycle {i}")
        held(out, want_i, f"whatif_isolation cycle {i}")
        if i:
            alone.append(out["cycle_s"])
    plans, errors, beside = [], [], []

    def fire():
        try:
            plans.append(wi.plan(mutations_from_dicts([{
                "kind": "inject_gang", "queue": "whatif", "gang_cardinality": 8, "cpu": "4",
                "memory": "8Gi"}]), rounds=2))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    for wave in range(ISOLATION_WAVES):
        threads = [threading.Thread(target=fire) for _ in range(ISOLATION_PLANS)]
        for th in threads:
            th.start()
        first = len(beside)
        while any(th.is_alive() for th in threads) or len(beside) - first < ISOLATION_MIN_CYCLES:
            i = len(want) + len(beside)
            in_flight = sum(th.is_alive() for th in threads)
            out = cycle(w, f"whatif_isolation cycle {i}")
            held(out, cycle(twin, f"twin cycle {i}"), f"whatif_isolation cycle {i}")
            _require_warm(out["stats"]["compiles"], f"whatif_isolation cycle {i}")
            beside.append({"wave": wave, "cycle_s": out["cycle_s"],
                           "solve_s": out["stats"]["solve_s"], "leased": len(out["leases"]),
                           "plans_in_flight": in_flight})
        for th in threads:
            th.join()
    if errors or len(plans) != ISOLATION_PLANS * ISOLATION_WAVES:
        raise AssertionError(f"whatif_isolation: {len(plans)} plans, errors {errors!r}")
    if any(p.injected[0]["eta_rounds"] is None for p in plans):
        raise AssertionError("whatif_isolation: an injected gang did not start")
    stats = list(wi.plan_stats)
    if len({s["pid"] for s in stats} | {os.getpid()}) != ISOLATION_PLANS + 1:
        raise AssertionError(f"whatif_isolation: rollouts ran in {[s['pid'] for s in stats]}")
    for s in stats:
        require_fill_launches(s["launches"], "whatif_isolation: a rollout")
    for s in stats[ISOLATION_PLANS:]:
        if s["sent"] * 10 > s["jobs"]:
            raise AssertionError(f"whatif_isolation: a plan on a rollout process that held "
                                 f"the fork's specs sent {s['sent']} of {s['jobs']}")
    wi.close()
    during = [b for b in beside if b["plans_in_flight"]]
    n = ISOLATION_PLANS
    slowest = max(during, key=lambda b: b["cycle_s"])
    ratio = (statistics.median(b["cycle_s"] for b in during) / statistics.median(alone))
    if ratio > ISOLATION_MAX_RATIO:
        raise AssertionError(f"whatif_isolation: the median live cycle beside the rollouts is "
                             f"{ratio:.2f}x the median alone (at most {ISOLATION_MAX_RATIO}x)")
    rec["whatif_isolation"] = {
        "budget_s": PERSIST_BUDGET_S, "plans": ISOLATION_PLANS, "workers": ISOLATION_PLANS,
        "waves": ISOLATION_WAVES, "alone_cycle_s": alone, "beside": beside,
        "median_alone_s": statistics.median(alone),
        "median_beside_s": statistics.median(b["cycle_s"] for b in during),
        "median_beside_s_by_wave": [
            statistics.median(b["cycle_s"] for b in during if b["wave"] == k)
            for k in range(ISOLATION_WAVES)],
        "max_beside_s": slowest["cycle_s"],
        "slowest_beside": {"cycle_s": slowest["cycle_s"], "solve_s": slowest["solve_s"],
                           "wave": slowest["wave"], "budget_s": PERSIST_BUDGET_S},
        "ratio": ratio, "max_ratio": ISOLATION_MAX_RATIO,
        "plan_s": [p.plan_seconds for p in plans],
        "live_s_by_wave": [[s["live_s"] for s in stats[k * n:(k + 1) * n]]
                           for k in range(ISOLATION_WAVES)],
        "plan_stats": plan_costs(stats),
        "rollout_launches": [s["launches"] for s in stats],
        "live_equals_twin": True,
        "launches": take_launches(launches, "whatif_isolation", [s["launches"] for s in stats]),
        "seconds": time.time() - t0,
    }
    rec["launches"] = launches
    return rec


LOOKOUT_JOBS, LOOKOUT_NODES = 100_000, 5000  # service_100k's width
LOOKOUT_LIVE_CYCLES = 5  # 1 cold and 4 warm, with the sync loops and requests beside them
LOOKOUT_ALONE_CYCLES = 3  # then warm cycles with the loops stopped and no requests
LOOKOUT_SYNC_INTERVAL_S = 0.05  # the sync loops' spacing (BackgroundTaskManager)
LOOKOUT_WAIT_S = 120.0  # the stores reach the log's end within this after a cycle
# What a Lookout page polls while a cycle runs: one request each
# LOOKOUT_REQUEST_INTERVAL_S, these in turn.
LOOKOUT_BESIDE = ("/api/jobs?queue=queue-01&order=submitted&take=100",
                  "/api/groups?by=queue", "/api/queues")
LOOKOUT_REQUEST_INTERVAL_S = 0.1


def phase_lookout(tmp, n_jobs=LOOKOUT_JOBS, n_nodes=LOOKOUT_NODES, device=None):
    """Lookout and the query side beside a kernel service on the card
    (phase 16). A ServiceRun at service_100k's width (n_jobs queued jobs
    in 10 queues, two executors of n_nodes / 2 nodes, the
    bench's config: fast fill, window 2,048) on the kernel backend, whose
    one rung on the card is local:cuda (score_nodes, fill_take and
    segment_add), recording its rounds to an .atrace and its spans to an
    OTLP file under `tmp`. A LookoutStore, a SqliteLookoutStore (under
    `tmp`) and an EventStreamIndex follow its log: each syncs the
    ingested jobs once (timed), then a BackgroundTaskManager runs their
    sync loops, as the JAX package's control plane registers them. A
    LookoutHttpServer on port 0 serves QueryApi(lookout=the in-memory
    store, timeline=the scheduler's) with the service's BinocularsService
    and a SubmitService for the UI's mutations.
    - LOOKOUT_LIVE_CYCLES cycles (1 cold, 4 warm), each with a thread
      sending the GET requests of LOOKOUT_BESIDE in turn, one each
      LOOKOUT_REQUEST_INTERVAL_S, while it runs. After each, once
      every store has reached the log's end: the in-memory and SQLite
      rows equal (run ids included: both follow the one log); their
      per-queue counts by state (a group-by on each, SQL on SQLite)
      the job database's; the index's per-jobset streams a scan of the
      log; and a fixed set of requests (`/api/jobs` with a queue filter,
      ordered and paged; `/api/groups` by queue with state counts;
      `/api/details` and `/api/jobtrace` of a leased job;
      `/api/fairshare`, `/api/fairness`, `/api/report`, `/api/doctor`;
      `/api/logs` of a leased job) answer bodies equal to the direct
      QueryApi, scheduler and binoculars calls.
    - After the third cycle, one POST /api/cancel and one POST
      /api/reprioritize: the heads of two queues served in that cycle;
      the next cycle leases neither (the cancelled job is cancelled in
      the job database and the rows, the other queued at its new
      priority there) while it leases jobs behind both in their queues.
    - Then LOOKOUT_ALONE_CYCLES warm cycles with the sync loops stopped
      and no requests, the stores synced after each by direct calls and
      held to the same checks.
    - The port's fairness_report over the recorded bundle exits 0 and
      names every queue; trace2perfetto over the bundle and the span file
      validates and holds one round slice per recorded round.
    Every background task runs without a failure and stops when asked;
    a request's error status, a sync loop's failure or a server thread's
    exception fails the phase. Prints each store's first sync (seconds
    and events) and its later syncs (in the loops), the SQLite file's
    bytes, the requests' median and maximum latency, and the median live
    cycle against the median cycle alone, with their ratio (not gated:
    the interpreter-lock question of the what-if planner's rollouts)."""
    import contextlib
    import io
    import statistics
    import threading
    import urllib.error
    import urllib.parse
    import urllib.request
    from dataclasses import asdict

    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.services.binoculars import BinocularsService
    from armada_tpu_torch.services.event_index import EventStreamIndex
    from armada_tpu_torch.services.lookout_http import LookoutHttpServer
    from armada_tpu_torch.services.lookout_ingester import LookoutStore
    from armada_tpu_torch.services.lookout_sqlite import SqliteLookoutStore
    from armada_tpu_torch.services.queryapi import JobFilter, Order, QueryApi
    from armada_tpu_torch.services.submit import SubmitService
    from armada_tpu_torch.tools import fairness_report, trace2perfetto
    from armada_tpu_torch.trace import TraceRecorder
    from armada_tpu_torch.utils.tasks import BackgroundTaskManager
    from armada_tpu_torch.utils.tracing import OtlpJsonFileExporter, Tracer
    from armada_tpu_torch.workload import ServiceRun, submit_events

    rec, launches = {}, {name: 0 for name in K.KERNELS}
    t0 = time.time()
    cfg, entries, submit_s = submit_events(n_jobs)
    K.reset_launches()
    run = ServiceRun(cfg, entries, n_nodes, device=device)
    del entries
    sched, log = run.sched, run.sched.log
    if [r.label for r in sched._rungs][:1 if device else None] != ["local:cuda"]:
        raise AssertionError(f"lookout: the card's ladder is {[r.label for r in sched._rungs]}")
    atrace, spans = os.path.join(tmp, "lookout.atrace"), os.path.join(tmp, "lookout.otlp.jsonl")
    sched.attach_trace_recorder(TraceRecorder(atrace, source="scheduler", config=sched.config))
    tracer = Tracer(exporter=OtlpJsonFileExporter(spans, service_name="armada-tpu-torch"),
                    export_every=256)
    sched.attach_tracer(tracer)
    submit = SubmitService(sched.config, log, scheduler=sched)
    binoculars = BinocularsService(sched, run.executors)
    db_path = os.path.join(tmp, "lookout.db")
    stores = {"memory": LookoutStore(log, error_rules=sched.config.error_categories),
              "sqlite": SqliteLookoutStore(log, db_path, error_rules=sched.config.error_categories),
              "index": EventStreamIndex(log)}
    rec["service"] = {"submit_us_per_job": submit_s / n_jobs * 1e6,
                      "ingest_s": run.ingest_s, "seconds": time.time() - t0}

    syncs = {}
    for name, store in stores.items():
        t1 = time.perf_counter()
        n = store.sync()
        syncs[name] = {"first_s": time.perf_counter() - t1, "first_events": n, "later": []}
        if store.lag_events:
            raise AssertionError(f"lookout: the {name} store's first sync left {store.lag_events}")
    sync_lock = threading.Lock()

    def loop(name):
        store = stores[name]

        def sync():
            t1 = time.perf_counter()
            n = store.sync()
            if n:
                with sync_lock:
                    syncs[name]["later"].append((time.perf_counter() - t1, n))
        return sync

    tasks = BackgroundTaskManager()
    for name in stores:
        tasks.register(loop(name), LOOKOUT_SYNC_INTERVAL_S, f"lookout-sync-{name}")
    query = QueryApi(lookout=stores["memory"], timeline=sched.timeline)
    server = LookoutHttpServer(query, sched, submit, port=0, binoculars=binoculars)
    base = f"http://127.0.0.1:{server.port}"
    latencies = []

    def request(path, body=None):
        req = urllib.request.Request(
            base + path, data=None if body is None else json.dumps(body).encode(),
            headers={} if body is None else {"Content-Type": "application/json",
                                             "X-Requested-With": "armada-lookout"},
            method="GET" if body is None else "POST")
        t1 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read())
        except urllib.error.HTTPError as e:
            raise AssertionError(f"lookout: {path} answered {e.code}: {e.read()[:300]!r}") from e
        latencies.append(time.perf_counter() - t1)
        return out

    def direct(obj):
        return json.loads(json.dumps(obj, default=str))

    def fairshare():
        return {"pools": {pool: [
            {"queue": qr.queue, "fair_share": qr.fair_share,
             "adjusted_fair_share": qr.adjusted_fair_share, "actual_share": qr.actual_share,
             "scheduled_jobs": qr.scheduled_jobs, "preempted_jobs": qr.preempted_jobs,
             "top_reasons": dict(qr.top_reasons)} for qr in rep.queues.values()]
            for pool, rep in sched.reports.latest_reports().items()}}

    def routes(leased):
        """(path, direct body) of the fixed request set."""
        rows, total = query.get_jobs([JobFilter("queue", "queue-03")],
                                     Order("submitted", "asc"), 100, 50)
        q = urllib.parse.quote(json.dumps(["state_counts"]))
        return [
            ("/api/jobs?queue=queue-03&order=submitted&direction=asc&skip=100&take=50",
             {"jobs": [asdict(r) for r in rows], "total": total}),
            (f"/api/groups?by=queue&aggregates={q}",
             {"groups": query.group_jobs("queue", aggregates=["state_counts"])}),
            (f"/api/details/{leased}", query.job_details(leased)),
            (f"/api/jobtrace/{leased}", query.job_trace(leased)),
            ("/api/fairshare", fairshare()),
            ("/api/fairness", sched.fairness.snapshot()),
            ("/api/report", {"report": sched.reports.scheduling_report()}),
            ("/api/doctor", sched.doctor_report()),
            (f"/api/logs/{leased}", {"job_id": leased,
                                      "lines": binoculars.get_logs(leased, 100)}),
        ]

    def caught_up(label):
        """Waits for every store to reach the log's end and for each sync
        loop to finish two more runs (a store moves its cursor before its
        batch commits, so the second run started after the first had
        nothing left)."""
        deadline = time.time() + LOOKOUT_WAIT_S
        runs = None
        while True:
            if runs is None and not any(s.lag_events for s in stores.values()):
                runs = {k: st["runs"] + 2 for k, st in tasks.stats().items()}
            if runs is not None and all(st["runs"] >= runs[k]
                                        for k, st in tasks.stats().items()):
                break
            if time.time() > deadline:
                raise AssertionError(f"lookout {label}: the stores lag "
                                     f"{[s.lag_events for s in stores.values()]}")
            time.sleep(0.01)
        for name, st in tasks.stats().items():
            if st["failures"]:
                raise AssertionError(f"lookout {label}: the task {name} failed {st}")

    def check(out, label):
        t1 = time.time()
        mem = {r.job_id: r for r in stores["memory"].all_rows()}
        if {r.job_id: r for r in stores["sqlite"].all_rows()} != mem:
            raise AssertionError(f"lookout {label}: the SQLite rows are not the in-memory rows")
        want = {}
        for j in sched.jobdb.read_txn().all_jobs():
            want.setdefault(j.queue, {}).setdefault(j.state.value, 0)
            want[j.queue][j.state.value] += 1
        for name in ("memory", "sqlite"):
            groups = QueryApi(lookout=stores[name]).group_jobs("queue", aggregates=["state_counts"])
            got = {g["name"]: g["aggregates"]["state_counts"] for g in groups}
            if got != want:
                raise AssertionError(f"lookout {label}: the {name} store counts {got}, "
                                     f"the job database {want}")
        scan = {}
        for e in log.read(0, log.end_offset):
            scan.setdefault((e.sequence.queue, e.sequence.jobset), []).append(e.offset)
        for key, offsets in scan.items():
            if stores["index"].offsets_from(*key, 0, limit=len(offsets) + 1) != offsets:
                raise AssertionError(f"lookout {label}: the index's stream {key} is not the log's")
        leased = out["leases"][0][0]
        for path, body in routes(leased):
            if request(path) != direct(body):
                raise AssertionError(f"lookout {label}: {path} is not its direct call")
        return {"check_s": time.time() - t1, "rows": len(mem), "log_entries": log.end_offset}

    def cycle(label):
        out = run.cycle()
        st = out["stats"]
        if st["rung"] != "local:cuda" or st["failover"] is not None or not out["leases"]:
            raise AssertionError(f"lookout {label}: rung {st['rung']}, failover "
                                 f"{st['failover']}, {len(out['leases'])} leased")
        return out

    def heads(out):
        """job id of the head of each queue served by `out`'s cycle, in
        the within-queue order (priority, submitted, id), and the queue."""
        served = {}
        for job_id, _, _ in out["leases"]:
            q = sched.jobdb.get(job_id).queue
            served[q] = served.get(q, 0) + 1
        best = {}
        for j in sched.jobdb.read_txn().all_jobs():
            if j.state.value == "queued" and served.get(j.queue, 0) >= 2:
                key = (j.priority, j.spec.submitted_ts, j.id)
                if j.queue not in best or key < best[j.queue][0]:
                    best[j.queue] = (key, j.id)
        return sorted((q, jid) for q, (_, jid) in best.items())

    live, alone, mutations, errors = [], [], None, []
    try:
        for i in range(LOOKOUT_LIVE_CYCLES):
            stop = threading.Event()

            def beside():
                try:
                    k = 0
                    while not stop.is_set():
                        request(LOOKOUT_BESIDE[k % len(LOOKOUT_BESIDE)])
                        k += 1
                        stop.wait(LOOKOUT_REQUEST_INTERVAL_S)
                except Exception as e:  # noqa: BLE001 - raised below
                    errors.append(e)

            th = threading.Thread(target=beside, name="lookout-requests")
            th.start()
            out = cycle(f"live cycle {i}")
            stop.set()
            th.join()
            if errors:
                raise errors[0]
            if mutations is not None and "shown" not in mutations:
                got = {jid for jid, _, _ in out["leases"]}
                (qc, cancelled), (qr, reprio) = mutations["heads"]
                lq = {sched.jobdb.get(jid).queue for jid in got}
                if cancelled in got or reprio in got or not {qc, qr} <= lq:
                    raise AssertionError(f"lookout: after the mutations the cycle leased "
                                         f"{sorted(got & {cancelled, reprio})}, queues {lq}")
                caught_up(f"live cycle {i}")
                jc, jr = sched.jobdb.get(cancelled), sched.jobdb.get(reprio)
                rc, rr = stores["memory"].get(cancelled), stores["sqlite"].get(reprio)
                if (jc.state.value, rc.state, jc.latest_run) != ("cancelled", "cancelled", None) or \
                        (jr.state.value, jr.priority, rr.state, rr.priority) != (
                            "queued", 1000, "queued", 1000):
                    raise AssertionError(f"lookout: the mutations did not show: {jc.state} "
                                         f"{rc.state} {jr.state} {jr.priority} {rr.priority}")
                mutations.update(next_cycle_leased=len(got), shown=True)
            caught_up(f"live cycle {i}")
            live.append({"cycle_s": out["cycle_s"], "solve_s": out["stats"]["solve_s"],
                         "leased": len(out["leases"]), **check(out, f"live cycle {i}")})
            if i == 2:
                (qc, cancelled), (qr, reprio) = heads(out)[:2]
                if request("/api/cancel", {"queue": qc, "jobset": "bench",
                                           "job_ids": [cancelled]}) != {"cancelled": 1} or \
                        request("/api/reprioritize", {"queue": qr, "jobset": "bench",
                                                      "job_ids": [reprio], "priority": 1000}
                                ) != {"reprioritized": 1}:
                    raise AssertionError("lookout: a mutation was refused")
                mutations = {"heads": [[qc, cancelled], [qr, reprio]]}
        stragglers = tasks.stop_all(timeout=LOOKOUT_WAIT_S)
        if stragglers:
            raise AssertionError(f"lookout: the tasks {stragglers} did not stop")
        task_stats = tasks.stats()
        if any(st["failures"] or not st["runs"] for st in task_stats.values()):
            raise AssertionError(f"lookout: the sync loops {task_stats}")
        for i in range(LOOKOUT_ALONE_CYCLES):
            out = cycle(f"alone cycle {i}")
            for store in stores.values():
                store.sync()
            alone.append({"cycle_s": out["cycle_s"], "solve_s": out["stats"]["solve_s"],
                          "leased": len(out["leases"]), **check(out, f"alone cycle {i}")})
        sqlite_bytes = sum(os.path.getsize(p) for p in (db_path, db_path + "-wal")
                           if os.path.exists(p))
    finally:
        tasks.stop_all(timeout=LOOKOUT_WAIT_S)
        server.stop()
        stores["sqlite"].close()
    if not (mutations or {}).get("shown"):
        raise AssertionError("lookout: the mutations' cycle did not run")
    recorded = sched.trace_recorder.rounds_recorded
    sched.trace_recorder.close()
    tracer.flush()
    rec["launches"] = take_launches(launches, "lookout")

    t1 = time.time()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        rc = fairness_report.main([atrace])
    missing = [f"queue-{q:02d}" for q in range(10) if f"queue-{q:02d}" not in report.getvalue()]
    if rc != 0 or missing:
        raise AssertionError(f"lookout: fairness_report exited {rc}, missing {missing}")
    doc = trace2perfetto.convert([atrace, spans])
    problems = trace2perfetto.validate(doc)
    slices = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "round"]
    n_spans = sum(1 for e in doc["traceEvents"] if e.get("cat") == "span")
    rounds = LOOKOUT_LIVE_CYCLES + LOOKOUT_ALONE_CYCLES
    if problems or len(slices) != rounds or recorded != rounds or not n_spans:
        raise AssertionError(f"lookout: trace2perfetto {problems[:3]}, {len(slices)} round "
                             f"slices for {rounds} rounds, {n_spans} spans")
    rec["tools"] = {"fairness_report_rc": rc, "round_slices": len(slices), "spans": n_spans,
                    "atrace_bytes": os.path.getsize(atrace), "seconds": time.time() - t1}

    live_warm = [c["cycle_s"] for c in live[1:]]
    rec.update({
        "syncs": {name: {"first_s": s["first_s"], "first_events": s["first_events"],
                         "later_syncs": len(s["later"]),
                         "later_s": [x for x, _ in s["later"]],
                         "later_events": [n for _, n in s["later"]],
                         "later_median_s": (statistics.median(x for x, _ in s["later"])
                                            if s["later"] else None)}
                  for name, s in syncs.items()},
        "sqlite_bytes": sqlite_bytes,
        "requests": {"count": len(latencies), "median_s": statistics.median(latencies),
                     "max_s": max(latencies)},
        "live": live, "alone": alone, "mutations": mutations,
        "median_live_cycle_s": statistics.median(live_warm),
        "median_alone_cycle_s": statistics.median(c["cycle_s"] for c in alone),
        "live_over_alone": (statistics.median(live_warm)
                            / statistics.median(c["cycle_s"] for c in alone)),
        "tasks": task_stats,
    })
    return rec


WIRE_CYCLES = 5  # 1 cold and 4 warm, 10 virtual seconds apart
WIRE_SUBMIT_BATCH = 1000  # jobs in one REST submit request
WIRE_PARTITION_AT = 50  # the submit request sent inside the proxy's partition window
WIRE_WAIT_S = 10.0  # the proxy's listener goes down or comes back within this
WIRE_READ_LIMIT = 2_000_000  # log entries a REST events read may scan (all of them)


class Loopback:
    """The JSON wire minus its socket, as an executor agent's client:
    `_call(method, request)` passes the request through the codec
    (`grpc_api._encode`, `_decode`), runs `api.method_table()[method]` on
    it and passes the reply back through the codec. A handler's exception
    reaches the caller as it is, as an in-process `FencedError` does
    (`grpc_api.is_fenced_error`). Records each call's seconds and the
    encoded bytes of its reply by method."""

    def __init__(self, api):
        from armada_tpu_torch.services.grpc_api import _decode, _encode

        self._table = api.method_table()
        self._encode, self._decode = _encode, _decode
        self.seconds: dict = {}
        self.reply_bytes: dict = {}

    def _call(self, method, request):
        t0 = time.perf_counter()
        body = self._encode(self._table[method](self._decode(self._encode(request))))
        self.seconds.setdefault(method, []).append(time.perf_counter() - t0)
        self.reply_bytes.setdefault(method, []).append(len(body))
        return self._decode(body)


def job_spec_to_dict(spec) -> dict:
    """The JSON job dict of a JobSpec: the inverse of
    `grpc_api.job_spec_from_dict` (which reads no submitted_ts: the
    submit service stamps it)."""
    from dataclasses import asdict

    d = {"id": spec.id, "queue": spec.queue, "jobset": spec.jobset, "pools": list(spec.pools),
         "priority": spec.priority, "priority_class": spec.priority_class,
         "requests": dict(spec.requests), "node_selector": dict(spec.node_selector),
         "tolerations": [asdict(t) for t in spec.tolerations],
         "annotations": dict(spec.annotations),
         # A (queued, running) pair in the proto json_format shape, which
         # the parser turns back into the pair.
         "bid_prices": {k: {"queued": v[0], "running": v[1]} if isinstance(v, tuple) else v
                        for k, v in spec.bid_prices.items()},
         "command": list(spec.command),
         "services": [asdict(s) for s in spec.services],
         "ingresses": [asdict(i) for i in spec.ingresses]}
    if spec.gang is not None:
        d["gang"] = asdict(spec.gang)
    if spec.affinity is not None:
        d["affinity"] = {"terms": [{"expressions": [asdict(e) for e in t.expressions]}
                                   for t in spec.affinity.terms]}
    return d


class _NoContext:
    """The gRPC context `ApiServer._watch_entries` reads: always active."""

    @staticmethod
    def is_active():
        return True


def _listening(port, up):
    """Waits up to WIRE_WAIT_S for a connect to 127.0.0.1:`port` to
    succeed (`up`) or be refused; raises otherwise."""
    import socket

    deadline = time.time() + WIRE_WAIT_S
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                ok = True
        except OSError:
            ok = False
        if ok == up:
            return
        if time.time() > deadline:
            raise AssertionError(f"wire: the proxy's listener never went {'up' if up else 'down'}")
        time.sleep(0.02)


class LoopbackClient:
    """An ApiClient over a `Loopback`: every ApiClient method but
    `watch_jobset` runs as written in services/grpc_api.py, its `_call`
    going through the method table over the JSON codec; `watch_jobset`
    streams the ApiServer's WatchJobSet handler through the codec. Keeps
    the ids of every SubmitJobs reply, in order (`submitted`)."""

    def __init__(self, api):
        self.api = api
        self.wire = Loopback(api)
        self.submitted = []

    def _call(self, method, request, timeout=None):
        out = self.wire._call(method, request)
        if method == "SubmitJobs":
            self.submitted += out["job_ids"]
        return out

    def watch_jobset(self, queue, jobset, from_offset=0, watch=True):
        req = self.wire._decode(self.wire._encode(
            {"queue": queue, "jobset": jobset, "from_offset": from_offset, "watch": watch}))
        for msg in self.api._watch_jobset(req, _NoContext()):
            yield self.wire._decode(msg)

    def __getattr__(self, name):
        from armada_tpu_torch.services.grpc_api import ApiClient

        return getattr(ApiClient, name).__get__(self)


class ClientStack:
    """A control plane of the port wired as services/server.py's
    ControlPlane wires it, minus its gRPC listener and its Lookout view:
    an in-memory log, a SchedulerService (kernel backend on `device`, the
    config's solve kernel path `kernel_path`) with an SLOTracker, a
    SubmitService, a QueryApi over the job database, FakeExecutors of
    `executors` (ControlPlane's `fake_executors` dicts), a
    BinocularsService, an EventStreamIndex, with `whatif` a
    WhatIfService, and an ApiServer (`serve()` never called), reached
    through a LoopbackClient (`client`). `cycle(now)` runs one turn of
    ControlPlane._loop at `now`; `start(period)` runs that loop on the
    wall clock in a thread of its own, as ControlPlane.start does, and
    keeps any exception of a cycle in `errors`."""

    def __init__(self, cfg, kernel_path, executors, device=None, whatif=False):
        import dataclasses

        from armada_tpu_torch.events import InMemoryEventLog
        from armada_tpu_torch.services.binoculars import BinocularsService
        from armada_tpu_torch.services.event_index import EventStreamIndex
        from armada_tpu_torch.services.fake_executor import FakeExecutor, make_nodes
        from armada_tpu_torch.services.grpc_api import ApiServer
        from armada_tpu_torch.services.queryapi import QueryApi
        from armada_tpu_torch.services.scheduler import SchedulerService
        from armada_tpu_torch.services.slo import SLOTracker
        from armada_tpu_torch.services.submit import SubmitService

        self.log = InMemoryEventLog()
        self.sched = SchedulerService(dataclasses.replace(cfg, solve_kernel_path=kernel_path),
                                      self.log, backend="kernel", device=device)
        self.now = 0.0
        # The tracker's windows end at the last cycle's time, the clock its
        # observations carry.
        self.sched.attach_slo(SLOTracker.from_config(self.sched.config, clock=lambda: self.now))
        self.submit = SubmitService(self.sched.config, self.log, scheduler=self.sched)
        self.query = QueryApi(self.sched.jobdb, timeline=self.sched.timeline)
        self.executors = [
            FakeExecutor(spec["name"], self.log, self.sched,
                         nodes=make_nodes(spec["name"], count=int(spec["nodes"]), cpu=spec["cpu"],
                                          memory=spec["memory"], labels=spec.get("labels"),
                                          extra_resources=spec.get("extra_resources")),
                         runtime_for=lambda job_id, rt=float(spec["runtime"]): rt)
            for spec in executors]
        self.binoculars = BinocularsService(self.sched, self.executors)
        self.index = EventStreamIndex(self.log)
        self.whatif = None
        if whatif:
            from armada_tpu_torch.whatif import WhatIfService

            # Rollout cycles 10 s apart, as phase 18 cycles its stacks.
            self.whatif = WhatIfService(self.sched, cycle_interval=10.0)
            self.sched.attach_whatif(self.whatif)
        self.api = ApiServer(self.submit, self.sched, self.query, self.log,
                             binoculars=self.binoculars, event_index=self.index)
        self.client = LoopbackClient(self.api)
        self.errors = []
        self.cycles = 0
        self._stop = None
        self._thread = None

    def cycle(self, now):
        self.now = now
        for ex in self.executors:
            ex.tick(now)
        return self.sched.cycle(now=now)

    def start(self, period):
        import threading

        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                try:
                    self.cycle(time.time())
                    self.cycles += 1
                except Exception as e:  # noqa: BLE001 - kept, and fails the phase
                    self.errors.append(repr(e))
                self._stop.wait(period)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def close(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=30)
        if self.whatif is not None:
            self.whatif.close()


class WireStack(ClientStack):
    """One stack of phase 17: a ClientStack with no executors and no
    planner (kernel backend on `device`, the config's solve kernel path
    `kernel_path`), with a RestGateway on port 0 over the same objects,
    behind a ChaosProxy whose FaultPlan runs on `clock`, and `n_agents`
    ExecutorAgents of `nodes_per_agent` nodes of 32 cpu / 256Gi each
    (`ServiceRun`'s nodes), pods running an hour, whose client is the
    stack's Loopback (`wire`)."""

    def __init__(self, cfg, kernel_path, clock, plan, n_agents, nodes_per_agent, device=None):
        from armada_tpu_torch.services.executor_agent import ExecutorAgent, _PodRuntime
        from armada_tpu_torch.services.fake_executor import make_nodes
        from armada_tpu_torch.services.netchaos import ChaosProxy
        from armada_tpu_torch.services.rest_gateway import RestGateway

        super().__init__(cfg, kernel_path, [], device=device)
        self.rest = RestGateway(self.submit, self.sched, self.query, self.log, port=0,
                                api=self.api)
        self.proxy = ChaosProxy("rest", "127.0.0.1", self.rest.port, plan, clock=clock)
        self.proxy.start()
        self.base = f"http://{self.proxy.address}"
        self.wire = self.client.wire
        self.agents = []
        for k in range(n_agents):
            name = f"executor-{k}"
            nodes = [{"id": n.id, "name": n.name, "labels": dict(n.labels),
                      "total_resources": dict(n.total_resources)}
                     for n in make_nodes(name, count=nodes_per_agent, cpu="32", memory="256Gi")]
            self.agents.append(ExecutorAgent(self.wire, name, nodes,
                                             runtime=_PodRuntime(runtime_s=3600.0)))

    def close(self):
        self.proxy.stop()
        self.rest.stop()
        super().close()


def _rest(base, path, body=None, latencies=None):
    """One REST call through the proxy: the decoded JSON reply; raises
    on an error status or a failed connection (URLError)."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if body is None else "POST",
                                 headers={} if body is None else {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        out = json.loads(r.read())
    if latencies is not None:
        latencies.append(time.perf_counter() - t0)
    return out


def _canon(obj):
    """`obj` as the JSON wire carries it, in one canonical text (NaN
    included), so a reply and its direct call compare exactly."""
    from armada_tpu_torch.services.grpc_api import _decode, _encode

    return json.dumps(_decode(_encode(obj)), sort_keys=True)


def _wire_reads(stack, queue, jobset, leased, queued):
    """The phase's reads on one stack, each against its direct call:
    REST /api/v1/jobs (a queue's rows) and QueryApi.get_jobs; REST
    /api/v1/queues and ListQueues through the loopback; REST
    /api/v1/jobset/<q>/<js>/events from 0, the log's scan of that
    jobset, and the index's stream (`_watch_entries` with watch off,
    paged from each batch's last offset); GetJobs, GroupJobs,
    SchedulingReport, QueueReport, JobReport, Doctor, FairnessReport and
    GetJobLogs (a queued job's; a leased job's raises the same KeyError
    both ways: an agent serves no logs) through the loopback against the
    scheduler's and the query API's own calls."""
    import dataclasses

    from armada_tpu_torch.services.queryapi import JobFilter, Order

    sched, query, wire = stack.sched, stack.query, stack.wire
    rows, total = query.get_jobs([JobFilter("queue", queue)], Order("submitted", "desc"), 0, 100)
    want = {"jobs": [dataclasses.asdict(r) for r in rows], "total": total}
    if _rest(stack.base, f"/api/v1/jobs?queue={queue}") != json.loads(json.dumps(want, default=str)):
        raise AssertionError(f"wire: REST jobs of {queue} are not QueryApi.get_jobs")
    if _rest(stack.base, "/api/v1/queues") != wire._call("ListQueues", {}):
        raise AssertionError("wire: REST queues are not ListQueues")
    got = _rest(stack.base, f"/api/v1/jobset/{queue}/{jobset}/events?from=0&watch=false"
                            f"&limit={WIRE_READ_LIMIT}")
    end = stack.log.end_offset

    def expand(pairs):
        return [{"offset": off, "type": type(e).__name__, "job_id": getattr(e, "job_id", ""),
                 "created": getattr(e, "created", 0.0)} for off, seq in pairs for e in seq.events]

    scan = [(x.offset, x.sequence) for x in stack.log.read(0, end)
            if x.sequence.queue == queue and x.sequence.jobset == jobset]
    stream, cursor = [], 0
    while True:
        batch = list(stack.api._watch_entries(queue, jobset, cursor, False, _NoContext()))
        if not batch:
            break
        stream += batch
        cursor = batch[-1][0] + 1
    if got["events"] != json.loads(json.dumps(expand(scan))) or got["next"] != end:
        raise AssertionError(f"wire: REST events of {queue}/{jobset} are not the log's scan")
    if [o for o, _ in stream] != [o for o, _ in scan]:
        raise AssertionError(f"wire: the index's stream of {queue}/{jobset} is not the log's scan")
    filters = [{"field": "queue", "value": queue}]
    calls = [
        ("GetJobs", {"filters": filters, "order_field": "submitted", "order_direction": "asc",
                     "skip": 50, "take": 100},
         lambda: (lambda r: {"jobs": [dataclasses.asdict(x) for x in r[0]], "total": r[1]})(
             query.get_jobs([JobFilter("queue", queue)], Order("submitted", "asc"), 50, 100))),
        ("GroupJobs", {"group_by": "queue", "aggregates": ["state_counts"]},
         lambda: {"groups": query.group_jobs("queue", [], ["state_counts"])}),
        ("SchedulingReport", {}, lambda: {"report": sched.reports.scheduling_report()}),
        ("QueueReport", {"queue": queue}, lambda: {"report": sched.reports.queue_report(queue)}),
        ("JobReport", {"job_id": leased}, lambda: {"report": sched.reports.job_report(leased)}),
        ("Doctor", {}, sched.doctor_report),
        ("FairnessReport", {"pool": ""}, sched.fairness.snapshot),
        ("GetJobLogs", {"job_id": queued, "tail_lines": 100},
         lambda: {"lines": stack.binoculars.get_logs(queued, 100)}),
    ]
    for method, req, direct in calls:
        if _canon(wire._call(method, req)) != _canon(direct()):
            raise AssertionError(f"wire: {method} through the loopback is not its direct call")
    errors = []
    for fn in (lambda: wire._call("GetJobLogs", {"job_id": leased}),
               lambda: stack.binoculars.get_logs(leased, 100)):
        try:
            fn()
            errors.append(None)
        except KeyError as e:
            errors.append(str(e))
    if errors[0] is None or errors[0] != errors[1]:
        raise AssertionError(f"wire: GetJobLogs of a leased job gave {errors}")


def phase_wire(n_jobs=100_000, n_nodes=5000, device=None, cycles=WIRE_CYCLES,
               batch=WIRE_SUBMIT_BATCH, partition_at=WIRE_PARTITION_AT):
    """The wire and the executor side on the card (phase 17). Two stacks
    (`WireStack`), one on the "cuda" path and one on "lax", each with two
    ExecutorAgents of n_nodes / 2 nodes leasing through the ApiServer's
    method table over the JSON codec (`Loopback`). service_100k's jobs
    (`build_inputs(n_jobs, 1, n_running=0)`'s queued JobSpecs, the bench's
    config: fast fill, window 2,048) go in as JSON job dicts through each
    stack's RestGateway behind its ChaosProxy with urllib: the queues by
    POST /api/v1/queue, the jobs by POST /api/v1/job/submit in requests
    of `batch`, one jobset per queue, the same requests in the same order
    to both stacks. Request `partition_at` is sent inside a
    network_partition window on the proxy's clock and fails; sent again
    after the heal, it lands once. Job ids are matched between the
    stacks by submission order.
    Then 1 cold and `cycles` - 1 warm cycles, 10 virtual seconds apart
    from the wall clock after the submission, as the JAX package's
    ControlPlane._loop runs them: each agent's tick, the scheduler's
    cycle, the index's sync. After each: the cuda stack's leases (job,
    executor, node) equal the lax stack's, and every cycle leases; the
    ladders are local:cuda and LOCAL alone, with no failover; the cuda
    cycle launches score_nodes, fill_take and segment_add and the lax
    one none; every run the job database holds on an executor is a pod
    on that agent after its exchange and every pod a run, and each pod's
    reported phase (pending, running) is its job's state; the reads of
    `_wire_reads` equal their direct calls. After the fourth cycle a
    CancelJobs of a job leased two cycles before and a ReprioritizeJobs
    of a served queue's head (to 1,000) go through the loopback: the
    next cycle leases neither while it serves both queues, and the
    exchange after it carries the cancel run, after which the pod is
    gone. At the end each agent's ExecutorSync kills nothing, finds no
    orphan, and keeps exactly its pods; the stacks' job states are equal;
    each proxy forwarded at least the submit bodies sent outside the
    window and severed connections only inside it. Any exception of a
    handler, an agent tick or a proxy thread fails the phase. Prints the
    REST submit seconds and jobs a second, the requests' latencies, each
    agent's exchange seconds and lease reply bytes per cycle, the cycle
    seconds and the loopback calls' latencies."""
    import statistics
    import threading
    import urllib.error

    from armada_tpu_torch.events import JobRunLeased
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.services.chaos import FaultPlan, FaultSpec, VirtualClock
    from armada_tpu_torch.workload import build_inputs

    thread_errors = []
    hook = threading.excepthook

    def record(args):
        thread_errors.append(f"{args.thread.name if args.thread else '?'}: {args.exc_value!r}")
        hook(args)

    threading.excepthook = record
    rec, launches = {}, {name: 0 for name in K.KERNELS}
    cfg, _, _, queues, _, queued = build_inputs(n_jobs, 1, n_running=0, fast_fill=True,
                                                fill_window=2048)
    requests = []
    by_queue: dict = {}
    for job in queued:
        by_queue.setdefault(job.queue, []).append(job)
    for q in queues:
        jobs = by_queue.get(q.name, [])
        for i in range(0, len(jobs), batch):
            requests.append({"queue": q.name, "jobset": "bench",
                             "jobs": [job_spec_to_dict(j) for j in jobs[i:i + batch]]})
    clock = VirtualClock(0.0)
    plan = FaultPlan([FaultSpec("network_partition", "rest", start=100.0, duration=100.0)])
    stacks = {}
    try:
        for kp in ("cuda", "lax"):
            stacks[kp] = WireStack(cfg, kp, clock, plan, 2, n_nodes // 2, device=device)
        ladders = {kp: [r.label for r in s.sched._rungs] for kp, s in stacks.items()}
        if ladders["cuda"][:1 if device else None] != ["local:cuda"] or \
                ladders["lax"][:1 if device else None] != ["LOCAL"]:
            raise AssertionError(f"wire: the card's ladders are {ladders}")

        # Submission through the proxies.
        latencies = {kp: [] for kp in stacks}
        ids, sent_bytes = {kp: [] for kp in stacks}, {kp: 0 for kp in stacks}
        for q in queues:
            for kp, s in stacks.items():
                body = {"name": q.name, "priority_factor": q.priority_factor}
                _rest(s.base, "/api/v1/queue", body)
                sent_bytes[kp] += len(json.dumps(body))
        partition = {}
        for n, body in enumerate(requests):
            raw = json.dumps(body)
            if n == partition_at:
                # Read before the window opens: the probes below are real
                # connections, and one the proxy accepts as the window
                # opens is severed inside it.
                partition["severed_before"] = {kp: s.proxy.connections_severed
                                               for kp, s in stacks.items()}
                clock.now = 150.0
                for s in stacks.values():
                    _listening(s.proxy._listen_port, up=False)
                partition["log_end_before"] = {kp: s.log.end_offset for kp, s in stacks.items()}
                for kp, s in stacks.items():
                    try:
                        _rest(s.base, "/api/v1/job/submit", body)
                    except urllib.error.URLError as e:
                        partition.setdefault("failed", {})[kp] = repr(e.reason)
                    else:
                        raise AssertionError("wire: a submit inside the partition landed")
                    if s.log.end_offset != partition["log_end_before"][kp]:
                        raise AssertionError("wire: the partitioned submit reached the log")
                clock.now = 250.0
                for s in stacks.values():
                    _listening(s.proxy._listen_port, up=True)
                partition["severed_after"] = {kp: s.proxy.connections_severed
                                              for kp, s in stacks.items()}
            for kp, s in stacks.items():
                ids[kp] += _rest(s.base, "/api/v1/job/submit", body, latencies[kp])["job_ids"]
                sent_bytes[kp] += len(raw)
        if ids["cuda"] != ids["lax"] or ids["cuda"] != [d["id"] for r in requests
                                                        for d in r["jobs"]]:
            raise AssertionError("wire: the stacks' job ids are not the submitted ones")
        match = dict(zip(ids["lax"], ids["cuda"]))  # lax id -> cuda id, by submission order
        rec["submit"] = {kp: {"requests": len(xs), "jobs": len(ids[kp]), "seconds": sum(xs),
                              "jobs_per_s": len(ids[kp]) / sum(xs),
                              "median_latency_s": statistics.median(xs),
                              "max_latency_s": max(xs)} for kp, xs in latencies.items()}
        rec["submit"]["partition"] = partition

        # Cycles.
        t_start = float(int(time.time()))
        cycle_recs, leased_in, mutation = [], [], None
        for c in range(cycles):
            now = t_start + 10.0 * c
            crec = {"cycle": c}
            out = {}
            for kp, s in stacks.items():
                agents = []
                for agent in s.agents:
                    t1 = time.perf_counter()
                    reply = agent.tick(now)
                    agents.append({"name": agent.name, "exchange_s": time.perf_counter() - t1,
                                   "lease_reply_bytes": s.wire.reply_bytes["ExecutorLease"][-1],
                                   "leases_in_reply": len(reply["leases"]),
                                   "cancels_in_reply": len(reply["cancel_runs"]),
                                   "pods": len(agent.runtime.pods)})
                _check_pods(s, f"{kp} cycle {c}, after the exchange")
                K.reset_launches()
                t1 = time.perf_counter()
                seqs = s.cycle(now)
                cycle_s = time.perf_counter() - t1
                got = take_launches(launches, f"wire {kp} cycle {c}") if kp == "cuda" else \
                    dict(K.LAUNCHES)
                if kp == "lax" and any(got[k] for k in K.KERNELS):
                    raise AssertionError(f"wire: the lax cycle {c} launched {got}")
                s.index.sync()
                st = s.sched.last_cycle_stats
                if st["rung"] != ladders[kp][0] or st["failover"] is not None:
                    raise AssertionError(f"wire {kp} cycle {c}: rung {st['rung']}, "
                                         f"failover {st['failover']}")
                leases = sorted((e.job_id, e.executor, e.node_id) for seq in seqs
                                for e in seq.events if isinstance(e, JobRunLeased))
                if not leases:
                    raise AssertionError(f"wire {kp} cycle {c}: nothing leased")
                _check_phases(s, f"{kp} cycle {c}", mutation)
                out[kp] = leases
                crec[kp] = {"cycle_s": cycle_s, "leased": len(leases), "agents": agents,
                            "launches": {k: got[k] for k in K.KERNELS}}
            if out["cuda"] != sorted((match[j], e, n) for j, e, n in out["lax"]):
                raise AssertionError(f"wire cycle {c}: the cuda and lax stacks leased differently")
            leased_in.append(out["cuda"])
            if mutation is not None:
                got = {j for j, _, _ in out["cuda"]}
                lq = {stacks["cuda"].sched.jobdb.get(j).queue for j in got}
                if mutation["cancel"] in got or mutation["reprioritize"] in got or \
                        not {mutation["cancel_queue"], mutation["reprioritize_queue"]} <= lq:
                    raise AssertionError(f"wire: after the mutations cycle {c} leased "
                                         f"{sorted(got & {mutation['cancel'], mutation['reprioritize']})}"
                                         f", queues {sorted(lq)}")
                for kp, s in stacks.items():
                    jc = s.sched.jobdb.get(mutation["cancel"])
                    jr = s.sched.jobdb.get(mutation["reprioritize"])
                    if (jc.state.value, jr.state.value, jr.priority) != ("cancelled", "queued",
                                                                         1000):
                        raise AssertionError(f"wire {kp}: the mutations did not show: {jc.state} "
                                             f"{jr.state} {jr.priority}")
                mutation["next_cycle_leased"] = len(got)
            t1 = time.perf_counter()
            q = queues[c % len(queues)].name
            leased_job = out["cuda"][0][0]
            queued_job = next(j.id for j in stacks["cuda"].sched.jobdb.read_txn().all_jobs()
                              if j.state.value == "queued")
            for s in stacks.values():
                _wire_reads(s, q, "bench", leased_job, queued_job)
            crec["reads_s"] = time.perf_counter() - t1
            cycle_recs.append(crec)
            if c == cycles - 2:
                mutation = _wire_mutations(stacks, leased_in, out["cuda"])
        if mutation is None or "next_cycle_leased" not in mutation:
            raise AssertionError("wire: the mutations' cycle did not run")

        # The exchange after the last cycle, then the anti-entropy sync.
        now = t_start + 10.0 * cycles
        final = {}
        for kp, s in stacks.items():
            for agent in s.agents:
                reply = agent.tick(now)
                if agent.name == mutation["cancel_executor"]:
                    if mutation["cancel"] not in {x["job_id"] for x in reply["cancel_runs"]}:
                        raise AssertionError(f"wire {kp}: the cancel never reached {agent.name}")
                    if any(p["job_id"] == mutation["cancel"] for p in agent.runtime.pods.values()):
                        raise AssertionError(f"wire {kp}: the cancelled job's pod survived")
            _check_pods(s, f"{kp} final exchange")
            syncs = []
            for agent in s.agents:
                reply = agent.resync(now)
                if reply["kill_runs"] or reply["orphaned_run_ids"] or \
                        set(reply["kept_run_ids"]) != set(agent.runtime.pods):
                    raise AssertionError(f"wire {kp}: {agent.name}'s ExecutorSync gave "
                                         f"{len(reply['kill_runs'])} kills, "
                                         f"{len(reply['orphaned_run_ids'])} orphans, "
                                         f"{len(reply['kept_run_ids'])} kept of "
                                         f"{len(agent.runtime.pods)} pods")
                syncs.append({"name": agent.name, "kept": len(reply["kept_run_ids"]),
                              "fence_token": reply["fence_token"]})
            n = len(s.sched.jobdb.read_txn().all_jobs())
            if n != len(ids[kp]):
                raise AssertionError(f"wire {kp}: {n} jobs in the job database")
            final[kp] = {"syncs": syncs, "jobs": n}
        states = {kp: {j.id: j.state.value for j in s.sched.jobdb.read_txn().all_jobs()}
                  for kp, s in stacks.items()}
        if states["cuda"] != {match[j]: v for j, v in states["lax"].items()}:
            raise AssertionError("wire: the stacks' job states differ")
        proxies = {}
        for kp, s in stacks.items():
            p = s.proxy
            proxies[kp] = {"bytes_forwarded": p.bytes_forwarded, "body_bytes": sent_bytes[kp],
                           "connections": p.connections_total,
                           "severed": p.connections_severed}
            if p.bytes_forwarded < sent_bytes[kp]:
                raise AssertionError(f"wire {kp}: the proxy forwarded {p.bytes_forwarded} bytes, "
                                     f"the bodies sent outside the window {sent_bytes[kp]}")
            if partition["severed_before"][kp] or \
                    p.connections_severed != partition["severed_after"][kp]:
                raise AssertionError(f"wire {kp}: the proxy severed connections outside the "
                                     f"window ({partition}, {p.connections_severed})")
        wire = {}
        for kp, s in stacks.items():
            for method, xs in s.wire.seconds.items():
                w = wire.setdefault(method, [])
                w += xs
        rec["loopback"] = {m: {"calls": len(xs), "median_s": statistics.median(xs),
                               "max_s": max(xs)} for m, xs in sorted(wire.items())}
    finally:
        for s in stacks.values():
            s.close()
        threading.excepthook = hook
    if thread_errors:
        raise AssertionError(f"wire: a thread raised: {thread_errors[:3]}")
    warm = [c["cuda"]["cycle_s"] for c in cycle_recs[1:]]
    rec.update({"cycles": cycle_recs, "final": final, "proxies": proxies,
                "mutation": mutation, "ladders": ladders,
                "median_warm_cycle_s": statistics.median(warm) if warm else None,
                "launches": launches})
    return rec


def _check_pods(stack, label):
    """Every run the job database holds on an agent's executor (leased,
    pending, running) is a pod on that agent, and every pod is such a
    run."""
    want = {}
    for j in stack.sched.jobdb.read_txn().all_jobs():
        run = j.latest_run
        if run is not None and j.state.value in ("leased", "pending", "running"):
            want.setdefault(run.executor, set()).add(run.id)
    for agent in stack.agents:
        pods = set(agent.runtime.pods)
        if pods != want.get(agent.name, set()):
            raise AssertionError(f"wire {label}: {agent.name} holds {len(pods)} pods for "
                                 f"{len(want.get(agent.name, ()))} runs "
                                 f"({len(pods - want.get(agent.name, set()))} without a run)")


def _check_phases(stack, label, mutation):
    """Each pod's reported phase (pending, running) is its job's state in
    the job database, which has just ingested the agents' reports; the
    job cancelled by `mutation` is cancelled there, its pod alive until
    the next exchange carries the cancel."""
    for agent in stack.agents:
        for pod in agent.runtime.pods.values():
            if mutation is not None and pod["job_id"] == mutation["cancel"]:
                continue
            if pod["phase"] in ("pending", "running"):
                state = stack.sched.jobdb.get(pod["job_id"]).state.value
                if state != pod["phase"]:
                    raise AssertionError(f"wire {label}: {pod['job_id']} is {state}, its pod "
                                         f"{pod['phase']}")


def _wire_mutations(stacks, leased_in, last):
    """The CancelJobs of a job leased two cycles before (a pod on its
    agent) and the ReprioritizeJobs (to 1,000) of the head of a queue
    `last` served, through each stack's loopback; the same job ids (by
    submission order, equal here) in both."""
    cuda = stacks["cuda"]
    job_id, executor, _ = leased_in[-2][0]
    served = {}
    for jid, _, _ in last:
        q = cuda.sched.jobdb.get(jid).queue
        served[q] = served.get(q, 0) + 1
    cancel_queue = cuda.sched.jobdb.get(job_id).queue
    best = {}
    for j in cuda.sched.jobdb.read_txn().all_jobs():
        if j.state.value == "queued" and served.get(j.queue, 0) >= 2 and j.queue != cancel_queue:
            key = (j.priority, j.spec.submitted_ts, j.id)
            if j.queue not in best or key < best[j.queue][0]:
                best[j.queue] = (key, j.id)
    reprio_queue, (_, reprio) = sorted(best.items())[0]
    for s in stacks.values():
        pods = {p["job_id"] for a in s.agents for p in a.runtime.pods.values()}
        if job_id not in pods:
            raise AssertionError(f"wire: the job to cancel, {job_id}, has no pod")
        s.wire._call("CancelJobs", {"queue": cancel_queue, "jobset": "bench",
                                    "job_ids": [job_id], "reason": "phase 17"})
        s.wire._call("ReprioritizeJobs", {"queue": reprio_queue, "jobset": "bench",
                                          "job_ids": [reprio], "priority": 1000})
    return {"cancel": job_id, "cancel_queue": cancel_queue, "cancel_executor": executor,
            "reprioritize": reprio, "reprioritize_queue": reprio_queue}


# The load tester's queues, load-000 to load-008. It sends a batch to the
# queue of its first job's index modulo the queue count, so with batches of
# 1,000 only a count that does not divide 1,000 spreads them: 1,000 % 9 = 1
# puts consecutive batches in consecutive queues.
CLIENT_QUEUES = 9
CLIENT_BATCH = 1000  # jobs in one load-tester submit
CLIENT_CPU, CLIENT_MEMORY = "2", "4Gi"  # each load-tester job's requests
CLIENT_WHATIF_ROUNDS = 1  # the what-if and drain plans' horizon, in rounds
BROADSIDE_S = 3.0  # each broadside backend's measured seconds
TESTSUITE_PERIOD_S = 0.05  # the testsuite plane's cycle period (tests/test_testsuite.py)
# testsuite_cases/*.yaml as the card runs them (it has no PyYAML), in the
# order tests/test_testsuite.py runs them; a CPU test holds each equal to
# its file.
TESTSUITE_SPECS = {
    "basic": {"name": "basic", "timeout": 60, "queue": "ts-basic",
              "jobs": [{"count": 2, "requests": {"cpu": "1", "memory": "1Gi"}}],
              "expectedEvents": ["JobRunLeased", "JobRunRunning", "JobRunSucceeded",
                                 "JobSucceeded"]},
    "gang": {"name": "gang", "timeout": 60, "queue": "ts-gang",
             "jobs": [{"count": 4, "requests": {"cpu": "2", "memory": "1Gi"},
                       "gang": {"cardinality": 4}}],
             "expectedEvents": ["JobRunLeased", "JobRunRunning", "JobRunSucceeded",
                                "JobSucceeded"]},
    "gpu": {"name": "gpu", "timeout": 60, "queue": "ts-gpu",
            "jobs": [{"count": 2, "requests": {"cpu": "1", "memory": "1Gi",
                                               "nvidia.com/gpu": "1"}}],
            "expectedEvents": ["JobRunLeased", "JobRunRunning", "JobRunSucceeded",
                               "JobSucceeded"]},
    "node_selector": {"name": "node-selector", "timeout": 60, "queue": "ts-select",
                      "jobs": [{"count": 2, "requests": {"cpu": "1", "memory": "1Gi"},
                                "nodeSelector": {"zone": "z1"}}],
                      "expectedEvents": ["JobRunLeased", "JobRunSucceeded", "JobSucceeded"]},
    "reprioritization": {"name": "reprioritization", "timeout": 60, "queue": "ts-reprio",
                         "jobs": [{"count": 3, "priority": 100,
                                   "requests": {"cpu": "1", "memory": "1Gi"}}],
                         "actions": [{"afterSeconds": 0.5, "reprioritizeJobSet": 0}],
                         "expectedEvents": ["JobRunLeased", "JobRunSucceeded", "JobSucceeded"]},
    "categorization": {"name": "categorization", "timeout": 60, "queue": "ts-categ",
                       "jobs": [{"count": 2, "requests": {"cpu": "1", "memory": "1Gi"},
                                 "annotations": {"armadaproject.io/fail-simulation":
                                                 "oom killed: container"}}],
                       "expectedEvents": ["JobRunLeased", "JobRunErrors", "JobErrors"]},
    "cancellation": {"name": "cancellation", "timeout": 60, "queue": "ts-cancel",
                     "jobs": [{"count": 3, "requests": {"cpu": "1", "memory": "1Gi"}}],
                     "actions": [{"afterSeconds": 1.0, "cancelJobSet": True}],
                     "expectedEvents": ["JobRunLeased"]},
    "performance": {"name": "performance", "timeout": 120, "queue": "ts-perf",
                    "jobs": [{"count": 64, "requests": {"cpu": "1", "memory": "256Mi"}}],
                    "expectedEvents": ["JobRunLeased", "JobRunSucceeded", "JobSucceeded"]},
    "preemption": {"name": "preemption", "timeout": 90, "queue": "ts-preempt",
                   "jobs": [{"count": 12, "priorityClassName": "ts-low",
                             "requests": {"cpu": "8", "memory": "2Gi"},
                             "expectedEvents": ["JobRunLeased", "JobRunRunning"]},
                            {"count": 4, "priorityClassName": "ts-high",
                             "requests": {"cpu": "8", "memory": "2Gi"},
                             "submitDelaySeconds": 1.5,
                             "expectedEvents": ["JobRunLeased", "JobRunRunning",
                                                "JobRunSucceeded", "JobSucceeded"]}]},
}
# tests/test_testsuite.py::test_testsuite_detects_failure's spec: no node
# fits its job, so it must time out.
TESTSUITE_IMPOSSIBLE = {"name": "impossible", "timeout": 3, "queue": "ts-imp",
                        "jobs": [{"count": 1, "requests": {"cpu": "999", "memory": "1Gi"}}],
                        "expectedEvents": ["JobRunLeased"]}


def _testsuite_plane(device):
    """tests/test_testsuite.py's plane (`plane`, :13-40): ts-default,
    ts-low and ts-high, 6 nodes of 16 cpu / 64Gi with 4 GPUs each in zone
    z1, jobs running 3 s; on the "cuda" path."""
    from armada_tpu_torch.core.config import PriorityClass, SchedulingConfig

    config = SchedulingConfig(
        priority_classes={
            "ts-default": PriorityClass("ts-default", 1000, preemptible=True),
            "ts-low": PriorityClass("ts-low", 100, preemptible=True),
            "ts-high": PriorityClass("ts-high", 30000, preemptible=False),
        },
        default_priority_class="ts-default",
        protected_fraction_of_fair_share=0.0,
    )
    return ClientStack(config, "cuda", [{
        "name": "ts-exec", "nodes": 6, "cpu": "16", "memory": "64Gi", "runtime": 3.0,
        "labels": {"zone": "z1"}, "extra_resources": {"nvidia.com/gpu": "4"}}], device=device)


def _run_testsuite(device, launches):
    """Part (a) of phase 18: the nine specs through the port's
    TestSuiteRunner on the testsuite plane, cycling every
    TESTSUITE_PERIOD_S on its own thread; each must pass (the preemption
    spec with a job preempted), and the impossible spec must time out."""
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.testsuite import TestSpec, TestSuiteRunner

    K.reset_launches()
    stack = _testsuite_plane(device).start(TESTSUITE_PERIOD_S)
    results = {}
    try:
        runner = TestSuiteRunner(stack.client)
        for case, doc in TESTSUITE_SPECS.items():
            res = runner.run(TestSpec.from_dict(doc))
            results[case] = {"passed": res.passed, "seconds": res.duration_s, "jobs":
                             len(res.events_by_job), "reason": res.reason}
            if not res.passed:
                raise AssertionError(f"clients: testsuite {case} failed: {res.reason}")
        preempted = [j for j, evs in res.events_by_job.items() if "JobRunPreempted" in evs]
        if not preempted:
            raise AssertionError("clients: testsuite preemption preempted no job")
        res = runner.run(TestSpec.from_dict(TESTSUITE_IMPOSSIBLE))
        results["impossible"] = {"passed": res.passed, "seconds": res.duration_s,
                                 "reason": res.reason}
        if res.passed or "timeout" not in res.reason:
            raise AssertionError(f"clients: the impossible spec gave {res.passed}, {res.reason}")
    finally:
        stack.close()
    if stack.errors:
        raise AssertionError(f"clients: the testsuite plane's loop raised {stack.errors[:3]}")
    got = take_launches(launches, "clients testsuite")
    return {"specs": results, "preempted": len(preempted), "cycles": stack.cycles,
            "launches": {k: got[k] for k in launches}}


class _Commands:
    """Command lines run in process, on several threads at once (phase
    18 runs the "cuda" and the "lax" stack's together): within the
    context, sys.stdout and each of `modules`' `connect` answer per
    thread, so `run(client, fn, *args)` calls `fn(*args)` with the
    thread's writes to standard output taken and `connect` returning
    `client` (the CLIs reach a server through it); it returns (return
    value, output, seconds). Other threads' writes pass through."""

    def __init__(self, modules):
        import threading

        self.modules = modules
        self.local = threading.local()
        self.stream = sys.stdout

    def __enter__(self):
        self.saved = [sys.stdout] + [m.connect for m in self.modules]
        self.stream = sys.stdout
        sys.stdout = self
        for m in self.modules:
            m.connect = lambda server, ca_cert=None, token=None: self.local.client
        return self

    def __exit__(self, *exc):
        sys.stdout = self.saved[0]
        for m, connect in zip(self.modules, self.saved[1:]):
            m.connect = connect

    def write(self, text):
        return getattr(self.local, "out", self.stream).write(text)

    def flush(self):
        getattr(self.local, "out", self.stream).flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)

    def run(self, client, fn, *args):
        import io

        self.local.client, self.local.out = client, io.StringIO()
        t0 = time.perf_counter()
        try:
            got = fn(*args)
        finally:
            out = self.local.out.getvalue()
            del self.local.client, self.local.out
        return got, out, time.perf_counter() - t0


def _on_both(stacks, fn):
    """{kp: fn(kp, stack)} for every stack at once, each on a thread of
    its own; the first exception is raised."""
    import threading

    got, errors = {}, []

    def one(kp, s):
        try:
            got[kp] = fn(kp, s)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=item) for item in stacks.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {kp: got[kp] for kp in stacks}


def _job_order(stack):
    """The stack's job ids in the job database's within-queue order
    (queue, priority, submitted, id), which the round schedules by: the
    load tester's jobs are alike, so the stacks' jobs at one position
    are scheduled alike whatever ids the submit service drew."""
    jobs = stack.sched.jobdb.read_txn().all_jobs()
    return [j.id for j in sorted(jobs, key=lambda j: (j.queue, j.priority,
                                                      j.spec.submitted_ts, j.id))]


class _Canon:
    """One stack's CLI output in a form both stacks share: each job id as
    its position in `_job_order` (`job#<k>`), each run id as "<run>",
    each submit time as its batch (`t#<k>`; a job trace's clock time of
    its submit as "<t>"), a plan's solver label as "<solver>", a
    round's measured duration as "<s>", and what the round-latency SLO
    derives from the cycles' wall-clock seconds (its state, compliance,
    good count, burn rates and alert time; the observation count and
    thresholds stay) as placeholders, since a cold cycle's seconds fall
    either side of its 5 s threshold (4.9 to 6.7 s on the card); the doctor's
    rung lines name no rung, a run of equal lines kept once (the ladders
    differ by construction: on the card each stack has one rung, on the
    CPU the "cuda" stack's falls back to LOCAL, the "lax" stack's
    first)."""

    def __init__(self, order, submit_times):
        import re

        self.ids = {jid: f"job#{k}" for k, jid in enumerate(order)}
        self.times = {repr(t): f"t#{k}" for k, t in enumerate(submit_times)}
        self._id = re.compile(r"\bjob-[0-9a-z]{26}\b")
        self._run = re.compile(r"\brun-[0-9a-z]{26}\b")
        self._num = re.compile(r"\b\d{10}\.\d+\b")
        self._duration = re.compile(r"(duration: )\d+\.\d+s")
        self._submitted = re.compile(r"^(  submitted )\d\d:\d\d:\d\d", re.M)
        self._solver = re.compile(r"(· solver )\S+")
        self._latency = re.compile(
            r"^(\S+: )(?:ok|ALERTING)(  objective \S+ on round_seconds <= \S+  compliance )"
            r"\S+ \(\d+/(\d+ good\)  burn fast )\S+(/\S+ slow )\S+(/\S+)[^\n]*$", re.M)
        self._rung = re.compile(r"^  rung \S+:(?= )", re.M)
        self._rungs = re.compile(r"^(  rung <rung>:[^\n]*\n)(\1)+", re.M)

    def __call__(self, text):
        text = self._id.sub(lambda m: self.ids.get(m.group(0), "<new job>"), text)
        text = self._run.sub("<run>", text)
        text = self._num.sub(lambda m: self.times.get(m.group(0), m.group(0)), text)
        text = self._duration.sub(r"\1<s>", text)
        text = self._submitted.sub(r"\1<t>", text)
        text = self._solver.sub(r"\1<solver>", text)
        text = self._latency.sub(r"\1<state>\2<c> (<g>/\3<rate>\4<rate>\5", text)
        return self._rungs.sub(r"\1", self._rung.sub("  rung <rung>:", text))


def _client_commands(stacks, order, first, last):
    """armadactl's commands of part (b), as argv per stack ("cuda" ids,
    the "lax" stack's the jobs at the same positions), and the mutation
    they make: a cancel of a job leased in the first cycle, a
    reprioritise (to 1,000) of the head of a queue the last cycle served,
    a cordon of executor-0 (where best fit has packed every lease) and of
    executor-1's first node."""
    cuda = stacks["cuda"]
    to_lax = dict(zip(order["cuda"], order["lax"]))
    job, _, _ = first[0]
    j = cuda.sched.jobdb.get(job)
    served = {cuda.sched.jobdb.get(jid).queue for jid, _, _ in last}
    head = next(jid for jid in order["cuda"]
                if cuda.sched.jobdb.get(jid).queue in served
                and cuda.sched.jobdb.get(jid).state.value == "queued")
    h = cuda.sched.jobdb.get(head)
    node = sorted(n.id for n in stacks["cuda"].executors[1].nodes)[0]
    mutation = {"cancel": job, "reprioritize": head, "node": node,
                "executor": "executor-0"}
    common = [
        ["queue", "create", "ops", "--priority-factor", "2"],
        ["queue", "get", "load-000"],
        ["queue", "list"],
        ["jobs", "--queue", "load-001"],
        ["report", "scheduling"],
        ["report", "queue", "load-000"],
        ["report", "job", "{job}"],
        ["fairness"],
        ["fairness", "--json"],
        ["doctor"],
        ["slo"],
        ["job-trace", "{job}"],
        ["whatif", "--inject-gang", "ops:8", "--rounds", str(CLIENT_WHATIF_ROUNDS)],
        # Deadline 0: every run preempted at once, so the rollout's horizon
        # is the requested rounds and one more (the config's 600 s
        # deadline adds 61 rounds at 10 s apart).
        ["drain", "executor-0", "--dry-run", "--deadline-s", "0", "--rounds",
         str(CLIENT_WHATIF_ROUNDS)],
        ["cancel", "--queue", j.queue, "--jobset", j.jobset, "--job-id", "{job}"],
        ["reprioritize", "--queue", h.queue, "--jobset", h.jobset, "--job-id", "{head}",
         "--priority", "1000"],
        ["node", "cordon", node],
        ["executor", "cordon", "executor-0"],
    ]
    argv = {}
    for kp in stacks:
        ids = {"job": job, "head": head} if kp == "cuda" else \
            {"job": to_lax[job], "head": to_lax[head]}
        argv[kp] = [[a.format(**ids) for a in cmd] for cmd in common]
    return argv, mutation


def _armadactl(runner, stack, argv):
    """armadactl's `main(argv)` on `stack` through `runner` (a
    `_Commands`): its output, and its seconds, output rows and the
    encoded bytes of the replies it read."""
    from armada_tpu_torch.clients import cli

    wire = stack.client.wire
    before = {m: len(v) for m, v in wire.reply_bytes.items()}
    _, out, sec = runner.run(stack.client, cli.main, ["--server", "loopback"] + argv)
    replies = sum(sum(v[before.get(m, 0):]) for m, v in wire.reply_bytes.items())
    return out, {"seconds": sec, "rows": len(out.splitlines()), "reply_bytes": replies}


def _run_clients(n_jobs, n_nodes, device, launches):
    """Part (b) of phase 18: two stacks, "cuda" and "lax", fed `n_jobs`
    jobs by the port's load tester; armadactl's commands on both, equal
    once ids are mapped; the mutations shown by the next cycle; then
    broadside's in-process and SQLite backends."""
    from armada_tpu_torch.clients import cli, load_tester
    from armada_tpu_torch.clients.broadside import BroadsideConfig, Runner
    from armada_tpu_torch.events import JobRunLeased
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.workload import scheduling_config

    cfg = scheduling_config(n_running=0, fast_fill=True, fill_window=2048)
    executors = [{"name": f"executor-{k}", "nodes": n_nodes // 2, "cpu": "32",
                  "memory": "256Gi", "runtime": 3600.0} for k in range(2)]
    stacks, rec = {}, {}
    try:
        for kp in ("cuda", "lax"):
            stacks[kp] = ClientStack(cfg, kp, executors, device=device, whatif=True)
        # One stack after the other: the submit path is host Python, and two
        # at once take about twice as long each (PERF.md, phase 18).
        with _Commands((load_tester,)) as commands:
            load = {kp: commands.run(s.client, load_tester.main, [
                "--server", "loopback", "--queues", str(CLIENT_QUEUES), "--jobs", str(n_jobs),
                "--batch", str(CLIENT_BATCH), "--cpu", CLIENT_CPU, "--memory", CLIENT_MEMORY])
                for kp, s in stacks.items()}
        for kp, (rc, out, sec) in load.items():
            if rc != 0 or len(stacks[kp].client.submitted) != n_jobs:
                raise AssertionError(f"clients {kp}: the load tester gave {rc}, "
                                     f"{len(stacks[kp].client.submitted)} jobs")
            load[kp] = {**json.loads(out.strip().splitlines()[-1]), "seconds": sec}
        rec["load_tester"] = load

        # Virtual cycle times from the next whole second after the last
        # submit: no job is submitted after its first cycle.
        t_start = float(int(time.time())) + 1.0
        cycles, leased, order = [], [], {}

        def cycle(c):
            out, crec = {}, {"cycle": c}
            for kp, s in stacks.items():
                K.reset_launches()
                t1 = time.perf_counter()
                seqs = s.cycle(t_start + 10.0 * c)
                cycle_s = time.perf_counter() - t1
                got = take_launches(launches, f"clients {kp} cycle {c}") if kp == "cuda" else \
                    dict(K.LAUNCHES)
                if kp == "lax" and any(got[k] for k in K.KERNELS):
                    raise AssertionError(f"clients: the lax cycle {c} launched {got}")
                st = s.sched.last_cycle_stats
                if st["failover"] is not None:
                    raise AssertionError(f"clients {kp} cycle {c}: failover {st['failover']}")
                if not order.get(kp):
                    order[kp] = _job_order(s)
                out[kp] = sorted((e.job_id, e.executor, e.node_id) for seq in seqs
                                 for e in seq.events if isinstance(e, JobRunLeased))
                if not out[kp]:
                    raise AssertionError(f"clients {kp} cycle {c}: nothing leased")
                crec[kp] = {"cycle_s": cycle_s, "leased": len(out[kp]), "rung": st["rung"],
                            "launches": {k: got[k] for k in K.KERNELS}}
            to_cuda = dict(zip(order["lax"], order["cuda"]))
            if out["cuda"] != sorted((to_cuda[j], e, n) for j, e, n in out["lax"]):
                raise AssertionError(f"clients cycle {c}: the cuda and lax stacks leased "
                                     "differently")
            cycles.append(crec)
            leased.append(out["cuda"])

        cycle(0)
        cycle(1)
        argv, mutation = _client_commands(stacks, order, leased[0], leased[-1])
        canon = {}
        for kp, s in stacks.items():
            times = sorted({s.sched.jobdb.get(j).spec.submitted_ts for j in order[kp]})
            canon[kp] = _Canon(order[kp], times)
        commands, outputs, raw = [], {kp: [] for kp in stacks}, []
        for k in range(len(argv["cuda"])):
            with _Commands((cli,)) as runner:
                got = _on_both(stacks, lambda kp, s: _armadactl(runner, s, argv[kp][k]))
            crec = {"argv": argv["cuda"][k], **{kp: got[kp][1] for kp in stacks}}
            for kp in stacks:
                outputs[kp].append(canon[kp](got[kp][0]))
            raw.append(got["cuda"][0])
            if outputs["cuda"][-1] != outputs["lax"][-1]:
                raise AssertionError(f"clients: armadactl {' '.join(argv['cuda'][k][:2])} "
                                     "printed differently on the cuda and lax stacks:\n"
                                     f"{outputs['cuda'][-1][:2000]}\n---\n"
                                     f"{outputs['lax'][-1][:2000]}")
            commands.append(crec)
        jobs_rows = json.loads(raw[3])
        if jobs_rows["total"] <= 0 or len(jobs_rows["jobs"]) != min(100, jobs_rows["total"]):
            raise AssertionError(f"clients: jobs --queue gave {jobs_rows['total']} rows: "
                                 f"{raw[3][:300]}")

        # The mutations show in the next cycle.
        cycle(2)
        to_lax = dict(zip(order["cuda"], order["lax"]))
        for kp, s in stacks.items():
            ids = mutation if kp == "cuda" else {
                **mutation, "cancel": to_lax[mutation["cancel"]],
                "reprioritize": to_lax[mutation["reprioritize"]]}
            jc, jr = s.sched.jobdb.get(ids["cancel"]), s.sched.jobdb.get(ids["reprioritize"])
            if (jc.state.value, jr.priority) != ("cancelled", 1000):
                raise AssertionError(f"clients {kp}: the cancel and reprioritise did not show: "
                                     f"{jc.state} {jr.priority}")
            if "executor-0" not in s.sched.cordoned_executors:
                raise AssertionError(f"clients {kp}: executor-0 is not cordoned")
            node = next(n for n in s.executors[1].nodes if n.id == mutation["node"])
            if not node.unschedulable:
                raise AssertionError(f"clients {kp}: {mutation['node']} is not cordoned")
        last = leased[-1]
        if mutation["reprioritize"] in {j for j, _, _ in last} or \
                any(e != "executor-1" or n == mutation["node"] for _, e, n in last):
            raise AssertionError("clients: the cycle after the mutations leased "
                                 f"{sorted({(e, n) for _, e, n in last})[:5]}")
        mutation["next_cycle_leased"] = len(last)
        rec.update({"cycles": cycles, "commands": commands, "mutation": mutation,
                    "plans": {kp: plan_costs(s.whatif.plan_stats) for kp, s in stacks.items()}})
    finally:
        for s in stacks.values():
            s.close()

    broadside = {}
    for backend in ("inproc", "sqlite"):
        t0 = time.perf_counter()
        report = Runner(BroadsideConfig(
            backend=backend, duration_s=BROADSIDE_S, seed_jobs=n_jobs, batch=CLIENT_BATCH,
            progress_every_s=3600.0)).run()
        sec = time.perf_counter() - t0
        errors = {op: report[op]["errors"] for op in ("ingest", "get_jobs", "group_jobs",
                                                      "job_details")}
        if any(errors.values()) or not report["ingest"]["ops"] or not report["get_jobs"]["ops"]:
            raise AssertionError(f"clients: broadside {backend} gave {report}")
        broadside[backend] = {**report, "seconds": sec}
    rec["broadside"] = broadside
    return rec


def phase_clients(n_jobs=100_000, n_nodes=5000, device=None):
    """The clients, the CLIs and the testsuite on the card (phase 18):
    part (a), `_run_testsuite`; part (b), `_run_clients`. Prints per
    testsuite spec its seconds, the load tester's report, per cycle and
    stack the cycle's seconds and leases, per armadactl command its
    seconds, output rows and reply bytes on each stack, and broadside's
    reports."""
    from armada_tpu_torch.ops import kernels as K

    launches = {name: 0 for name in K.KERNELS}
    t0 = time.perf_counter()
    testsuite = _run_testsuite(device, launches)
    testsuite["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clients = _run_clients(n_jobs, n_nodes, device, launches)
    clients["seconds"] = time.perf_counter() - t0
    return {"testsuite": testsuite, **clients, "launches": launches}


class _Patches:
    """monkeypatch's `setattr` for code outside pytest: every attribute
    set is put back by `undo`."""

    def __init__(self):
        self._saved = []

    def setattr(self, owner, name, value):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)


def _conformance_module():
    """tests/torch_conformance.py from the checkout: the port's
    assert_parity twin and the cycle recording, with nothing of the JAX
    package (tests/test_torch_conformance_phase.py runs this phase with
    jax and armada_tpu blocked)."""
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_conformance

    return torch_conformance


def _conformance_rounds(device, thousand):
    """Part (a) of phase 19: tests/test_reference_tables.py's cases and
    tests/test_parity_scale.py's sweep (its opt-in 1,000-node case with
    `thousand`), compiled for the port, every round on "cuda" and "lax"
    through the twin."""
    TC = _conformance_module()
    tables = TC.port_module("test_reference_tables")
    scale = TC.port_module("test_parity_scale")
    sweep = [(tuple(args), "test_scale_parity") for mark in scale.test_scale_parity.pytestmark
             if mark.name == "parametrize" for args in mark.args[1]]
    if thousand:
        sweep.append(((), "test_thousand_node_parity"))
    cases = [(tables, name, ()) for name in TC.case_names(tables)]
    cases += [(scale, name, args) for args, name in sweep]
    rec = {}
    with TC.parity(device=device, paths=("cuda", "lax")) as state:
        for module, name, args in cases:
            before = dict(rounds=state.rounds, jobs=state.jobs, scheduled=state.scheduled,
                          preempted=state.preempted, **state.seconds)
            t0 = time.perf_counter()
            getattr(module, name)(*args)
            label = f"{name}{list(args) if args else ''}"
            rec[label] = {
                "seconds": time.perf_counter() - t0,
                **{k: getattr(state, k) - before[k]
                   for k in ("rounds", "jobs", "scheduled", "preempted")},
                "parts_s": {k: v - before.get(k, 0.0) for k, v in state.seconds.items()},
            }
        totals = {"rounds": state.rounds, "jobs": state.jobs, "scheduled": state.scheduled,
                  "preempted": state.preempted, "parts_s": dict(state.seconds)}
    n_tables = len(TC.case_names(tables))
    if n_tables != 27:
        raise AssertionError(f"conformance: {n_tables} Go table cases, expected 27")
    return {"cases": rec, "totals": totals, "table_cases": n_tables,
            "scale_cases": len(sweep)}


def _conformance_baseline(device):
    """Part (b) of phase 19: tests/test_baseline_configs.py's five
    configurations through the port's Simulator, on the kernel backend on
    `device` and on the oracle backend; each case's own assertions hold on
    both, and the leases after every scheduling cycle are equal."""
    import armada_tpu_torch.services.scheduler as scheduler_module
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.sim.simulator import Simulator

    TC = _conformance_module()
    base = TC.port_module("test_baseline_configs")
    names = TC.case_names(base)
    if len(names) != 5:
        raise AssertionError(f"conformance: {len(names)} baseline configurations, expected 5")
    histories, rec = {}, {}
    launches = {name: 0 for name in K.KERNELS}
    for backend in ("kernel", "oracle"):
        sims = _Patches()

        made = []

        def forced(*a, _backend=backend, **k):
            made.append(Simulator(*a, **{**k, "backend": _backend, "device": device}))
            return made[-1]

        sims.setattr(base, "Simulator", forced)
        try:
            for name in names:
                cycles = _Patches()
                try:
                    recorded = TC.record_cycles(cycles, scheduler_module)
                    K.reset_launches()
                    t0 = time.perf_counter()
                    getattr(base, name)()
                    seconds = time.perf_counter() - t0
                    got = dict(K.LAUNCHES)
                finally:
                    cycles.undo()
                if backend == "kernel":
                    for k in launches:
                        launches[k] += got[k]
                elif any(got.values()):
                    raise AssertionError(f"conformance {name}: the oracle run launched {got}")
                # Every round committed on the backend's first rung: a
                # rejection or failover would hide the kernel behind the
                # oracle (the CPU's ladder) or stall (the card's one rung).
                refused = [(r.get("invariant"), r.get("detail")) for sim in made
                           for r in list(sim.scheduler.recent_rejections)
                           + list(sim.scheduler.recent_failovers)]
                if refused:
                    raise AssertionError(f"conformance {name} on {backend}: rounds rejected or "
                                         f"failed over: {refused[:3]}")
                made.clear()
                histories[(name, backend)] = recorded
                rec.setdefault(name, {})[backend] = {
                    "seconds": seconds, "services": len(recorded),
                    "cycles": [len(h) for h in recorded],
                    **({"launches": got} if backend == "kernel" else {}),
                }
        finally:
            sims.undo()
    for name in names:
        kern, orc = histories[(name, "kernel")], histories[(name, "oracle")]
        if len(kern) != len(orc) or not kern:
            raise AssertionError(f"conformance {name}: {len(kern)} kernel services, "
                                 f"{len(orc)} oracle services")
        for k, (a, b) in enumerate(zip(kern, orc)):
            if len(a) != len(b):
                raise AssertionError(f"conformance {name}: service {k} ran {len(a)} cycles on "
                                     f"the kernel, {len(b)} on the oracle")
            for i, (x, y) in enumerate(zip(a, b)):
                if x != y:
                    raise AssertionError(f"conformance {name}: service {k}, cycle {i}: the "
                                         f"kernel's leases differ from the oracle's")
        rec[name]["history_equal"] = True
    require_fill_launches(launches, "conformance: BASELINE's configurations")
    return {"configs": rec, "launches": launches}


PARSER_SCALES = (-3, 0, 3, 8)  # tests/test_native.py's
PARSER_FUZZ = 20_000  # seeded quantities, tests/test_native.py's generator
PARSER_JOBS = 1_000_000  # the flagship's workload build


def _conformance_parser(n_jobs):
    """Part (c) of phase 19: the port's quantity parser, built on this
    host, against the Fraction path: tests/test_native.py's samples at
    every scale and rounding, a seeded fuzz (per-value seconds on both
    paths), and the request dicts of an `n_jobs` workload build
    (`workload.build_inputs`): its distinct specs encoded on both paths
    (the Fraction path is `from_map`), and the whole batch by the parser,
    each row the Fraction path's for its spec."""
    import math
    from fractions import Fraction

    import numpy as np

    from armada_tpu_torch.core.resources import parse_quantity
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.workload import build_inputs

    TC = _conformance_module()
    t0 = time.perf_counter()
    native = K.load_quantity()
    load_s = time.perf_counter() - t0

    def fraction(value, scale, ceil):
        scaled = parse_quantity(value) / (Fraction(10) ** scale)
        v = int(math.ceil(scaled) if ceil else math.floor(scaled))
        return min(max(v, -(2**63)), 2**63 - 1)

    samples = 0
    for value in TC.native_samples():
        for scale in PARSER_SCALES:
            for ceil in (True, False):
                got, want = native.parse_quantity(value, scale, ceil), fraction(value, scale, ceil)
                if got != want:
                    raise AssertionError(f"parser: {value!r} at scale {scale}, ceil {ceil}: "
                                         f"{got} against the Fraction path's {want}")
                samples += 1
    fuzz = TC.fuzz_quantities(seed=18, n=PARSER_FUZZ)
    t0 = time.perf_counter()
    got = [native.parse_quantity(v, scale, ceil) for v, scale, ceil in fuzz]
    fuzz_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [fraction(v, scale, ceil) for v, scale, ceil in fuzz]
    fuzz_fraction_s = time.perf_counter() - t0
    bad = [f for f, a, b in zip(fuzz, got, want) if a != b]
    if bad:
        raise AssertionError(f"parser: {len(bad)} fuzz values differ, first {bad[0]}")

    t0 = time.perf_counter()
    cfg, _, _, _, running, queued = build_inputs(n_jobs, max(1, n_jobs // 20))
    build_s = time.perf_counter() - t0
    factory = cfg.resource_factory()
    requests = [j.requests for j in queued] + [r.job.requests for r in running]
    def key(r):
        return tuple(sorted(r.items()))

    distinct = list({key(r): r for r in requests}.values())
    rec = {"load_s": load_s, "samples": samples, "fuzz": len(fuzz),
           "fuzz_native_s": fuzz_native_s, "fuzz_fraction_s": fuzz_fraction_s,
           "fuzz_native_us_per_value": 1e6 * fuzz_native_s / len(fuzz),
           "fuzz_fraction_us_per_value": 1e6 * fuzz_fraction_s / len(fuzz),
           "workload_jobs": len(requests), "workload_build_s": build_s,
           "distinct_specs": len(distinct)}
    for ceil in (True, False):
        # The compiled parser on the whole batch (uniquified, as the
        # snapshot encodes it) and on its distinct specs; the Fraction
        # path (`from_map`) on the distinct specs, each request's row
        # taken from them.
        t0 = time.perf_counter()
        batch = factory.encode_requests_batch(requests, ceil=ceil)
        batch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        unique = factory._encode_unique(distinct, ceil=ceil)
        unique_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = {key(r): factory.from_map(r, ceil=ceil) for r in distinct}
        plain_s = time.perf_counter() - t0
        if unique.dtype != np.int64 or unique.shape != (len(distinct), factory.num_resources) \
                or not np.array_equal(unique, np.stack([plain[key(r)] for r in distinct])):
            raise AssertionError(f"parser: the distinct specs' encoding (ceil {ceil}) differs "
                                 f"between the parser and the Fraction path")
        if batch.shape != (len(requests), factory.num_resources) \
                or not np.array_equal(batch, np.stack([plain[key(r)] for r in requests])):
            raise AssertionError(f"parser: the batch encoding (ceil {ceil}) differs from the "
                                 f"Fraction path's rows")
        rec[f"{'ceil' if ceil else 'floor'}"] = {
            "batch_native_s": batch_s, "distinct_native_s": unique_s,
            "distinct_fraction_s": plain_s}
    return rec


def phase_conformance(device=None, thousand=True, parser_jobs=PARSER_JOBS):
    """Placement conformance on the card (phase 19): part (a),
    `_conformance_rounds`; part (b), `_conformance_baseline`; part (c),
    `_conformance_parser`. Prints per case its seconds, rounds, jobs and
    decisions and the seconds of each part of a round, per configuration
    and backend its seconds and cycles, and the parser's checks and
    seconds."""
    from armada_tpu_torch.device import resolve_device
    from armada_tpu_torch.ops import kernels as K

    device = str(resolve_device(device))
    t0 = time.perf_counter()
    K.reset_launches()
    rounds = _conformance_rounds(device, thousand)
    rounds["launches"] = dict(K.LAUNCHES)
    K.reset_launches()
    require_fill_launches(rounds["launches"], "conformance: the Go tables and the scale sweep")
    rounds["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    baseline = _conformance_baseline(device)
    baseline["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parser = _conformance_parser(parser_jobs)
    parser["seconds"] = time.perf_counter() - t0
    launches = {name: rounds["launches"][name] + baseline["launches"][name] for name in K.KERNELS}
    return {"rounds": rounds, "baseline": baseline, "parser": parser, "launches": launches}


def _round_100k():
    """Phase 4: round_100k on "cuda" and "lax", bit-equal."""
    res, outs, _ = run_round(100_000, 5000, ("cuda", "lax"))
    assert_same_outputs(outs["cuda"], outs["lax"], "round: the cuda and lax paths")
    res["cuda_equals_lax"] = True
    return res


def _observatory():
    with tempfile.TemporaryDirectory(prefix="observatory-") as tmp:
        return phase_observatory(tmp)


def _autotune_whatif():
    with tempfile.TemporaryDirectory(prefix="autotune-") as tmp:
        return phase_autotune_whatif(tmp)


def _persistence():
    with tempfile.TemporaryDirectory(prefix="persistence-") as tmp:
        return phase_persistence(tmp)


def _lookout():
    with tempfile.TemporaryDirectory(prefix="lookout-") as tmp:
        return phase_lookout(tmp)


# The phases that need nothing of the others, in two processes of their
# own beside the first: phases 10, 12, 13, 16 and 19; phases 4, 11, 14,
# 15 and 18.
SIDE_PHASES = {
    "market": phase_market, "service": phase_service, "observatory": _observatory,
    "lookout": _lookout, "round": _round_100k, "warm": phase_warm,
    "autotune_whatif": _autotune_whatif, "persistence": _persistence, "clients": phase_clients,
    "conformance": phase_conformance,
}
SIDES = (("market", "service", "observatory", "lookout", "conformance"),
         ("round", "warm", "autotune_whatif", "persistence", "clients"))
SIDE_TIMEOUT_S = 1000.0


def side_main(out_path, names) -> int:
    """The phases `names` (of SIDE_PHASES) in a process of their own on
    the card, each printing its phase line; writes their records and this
    process's peak reserved device memory to `out_path`. They need
    nothing of the other phases, and every phase is host-bound, so the
    processes share the card's idle time."""
    import torch

    from armada_tpu_torch.device import resolve_device

    resolve_device()
    rec = {}
    for name in names:
        t0 = time.time()
        rec[name] = SIDE_PHASES[name]()
        emit({"phase": name, **rec[name], "seconds": time.time() - t0})
    rec["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


class SidePhases:
    """`side_main` of `names` in a child interpreter, started at
    construction. Its phase lines go to a file under `tmp` and are
    printed by `finish`, so they never interleave with this process's
    lines; its log goes to this process's standard error."""

    def __init__(self, tmp, names):
        tag = "-".join(names)
        self.names = names
        self.out_path = os.path.join(tmp, f"side-{tag}.json")
        self.log_path = os.path.join(tmp, f"side-{tag}.out")
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                f"sys.exit(chip_smoke.side_main({self.out_path!r}, {names!r}))")
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen([sys.executable, "-c", code], stdout=log, cwd=HERE)

    def finish(self) -> dict:
        """Waits for the side process, prints its phase lines and returns
        its records; raises if it failed."""
        rc = self.proc.wait(timeout=SIDE_TIMEOUT_S)
        with open(self.log_path) as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()
        if rc != 0:
            raise AssertionError(f"the side process (phases {', '.join(self.names)}) "
                                 f"exited with code {rc}")
        with open(self.out_path) as f:
            return json.load(f)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def main_phases(timing, sides):
    """Phases 5 to 7, 9 and 17 in this process while `sides` run 10, 12,
    13 and 16, and 4, 11, 14, 15 and 18, then phase 8 alone; returns
    their records and the sides' merged."""
    t0 = time.time()
    flag, flag_outs, dev_flag = run_round(1_000_000, 50_000, ("cuda",))
    emit({"phase": "flagship", **flag, "seconds": time.time() - t0})

    t0 = time.time()
    fast, (dev_fast, fast_out), dev_100k_fast = phase_fast_fill(dev_flag, flag["readback_rows"])
    emit({"phase": "fast_fill", **fast, "seconds": time.time() - t0})

    t0 = time.time()
    quarter = run_round(25_000, 1250, ("cuda",), n_running=1250)
    driver = phase_driver(dev_flag, flag, flag_outs["cuda"], dev_fast, fast["flagship_fast"],
                          fast_out, quarter)
    del flag_outs
    emit({"phase": "driver", **driver, "quarter_solve_s": quarter[0]["cuda_cold_solve_s"],
          "seconds": time.time() - t0})

    t0 = time.time()
    # Neither bench round selects a node: round_100k's 5,002 serial loops
    # return evicted jobs to their own nodes (a pinned reschedule reads
    # one node, it selects none) and the burst limit ends both rounds'
    # fills. So they require the fill kernels, and the winner kernel runs
    # in gangs_100k, whose gangs are placed member by member. The sharded
    # eviction round is round_100k at a quarter of its shape (round_25k:
    # 25,000 jobs x 1,250 nodes x 1,250 running, about 1,250 serial loops
    # of pinned returns and the fills), held to its own single-device
    # solve: the same paths at a quarter of the serial loops, which cost
    # most of the phase.
    fill_kernels = FILL_KERNELS
    quarter, quarter_outs, dev_quarter = quarter
    sharded = {
        "round_25k_single_device": quarter,
        "round_25k": run_sharded(
            dev_quarter, quarter_outs["cuda"], "round_25k", quarter["readback_rows"], fill_kernels
        ),
    }
    del quarter_outs, dev_quarter
    # Both sides of the sharded comparison below run score_nodes and
    # fill_take, so the single-device round is also held to the "lax" path,
    # which runs none of the kernels.
    gangs, gang_outs, dev_gangs = run_round(
        100_000, 5000, ("cuda", "lax"), n_running=0, gang_every=8
    )
    assert_same_outputs(gang_outs["cuda"], gang_outs["lax"], "gangs_100k: the cuda and lax paths")
    gangs["cuda_equals_lax"] = True
    sharded["gangs_100k_single_device"] = gangs
    sharded["gangs_100k"] = run_sharded(
        dev_gangs, gang_outs["cuda"], "gangs_100k", gangs["readback_rows"], ROUND_KERNELS
    )
    # The flagship's full node width on the mesh (N split 4 x 16,384), in
    # phase 6's fast-fill configuration: its 3 loops run the top-B merge at
    # B = 2,048 over all four shards. The fused flagship's 995 single-queue
    # fills would take about 52 s in threads, bound by the burst at about
    # one job a loop at any job count; round_25k and gangs_100k run that
    # fill on the mesh.
    sharded["flagship_fast"] = run_sharded(
        dev_fast, fast_out, "flagship_fast", flag["readback_rows"], fill_kernels
    )
    del fast_out
    emit({"phase": "sharded", **sharded, "seconds": time.time() - t0})

    t0 = time.time()
    policies = phase_policies(dev_flag, flag, dev_fast, fast, dev_100k_fast)
    del dev_flag, dev_fast, dev_100k_fast
    emit({"phase": "policies", **policies, "seconds": time.time() - t0})

    t0 = time.time()
    wire = phase_wire()
    emit({"phase": "wire", **wire, "seconds": time.time() - t0})

    # The ring drive times a kernel that spins across four processes'
    # contexts on the card, so it runs once the side processes have ended.
    side_rec = {}
    for side in sides:
        rec = side.finish()
        side_rec[f"peak_reserved_bytes_{'_'.join(side.names)}"] = rec.pop("peak_reserved_bytes")
        side_rec.update(rec)

    t0 = time.time()
    multiproc = phase_multiproc(
        dev_gangs, gang_outs["cuda"], gangs["readback_rows"],
        sharded["gangs_100k"]["collective_stats"],
    )
    del gang_outs, dev_gangs
    timing["ring_exchange"] = ring_timing(multiproc)
    emit({"phase": "multiproc", **multiproc, "seconds": time.time() - t0})
    return flag, fast, driver, sharded, multiproc, policies, wire, side_rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from armada_tpu_torch.device import resolve_device
    from armada_tpu_torch.ops import kernels as K

    resolve_device()
    t0 = time.time()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.time() - t0})

    t0 = time.time()
    ptxas = ptxas_start()
    libs = K.build_all()
    emit({"phase": "build", "libraries": libs, "seconds": time.time() - t0})
    ptxas = ptxas_finish(ptxas)
    # The library timing runs once the build is done, with the host quiet
    # as it is for the port's own times.
    library_ms = segment_library_finish(segment_library_start())

    t0 = time.time()
    checks, timing = phase_kernels()
    wchecks, timing["winner_reduce"] = phase_winner()
    schecks, timing["segment_add"] = phase_segment(library_ms)
    wchecks += schecks
    floor_ms = floor_device_ms()
    emit({"phase": "kernels", "checks": checks + wchecks, "timing": timing,
          "floor_device_ms": floor_ms, "seconds": time.time() - t0})

    with tempfile.TemporaryDirectory(prefix="smoke-side-") as side_dir:
        sides = []
        try:
            for names in SIDES:
                sides.append(SidePhases(side_dir, names))
            (flag, fast, driver, sharded, multiproc, policies, wire,
             side_rec) = main_phases(timing, sides)
        finally:
            for side in sides:
                side.stop()
    (res, warm, market, service, observatory, autotune_whatif, persistence, lookout, clients,
     conformance) = (
        side_rec[k] for k in ("round", "warm", "market", "service", "observatory",
                              "autotune_whatif", "persistence", "lookout", "clients",
                              "conformance"))
    emit({"phase": "peak_memory", "main_reserved_bytes": torch.cuda.max_memory_reserved(),
          **{k: v for k, v in side_rec.items() if k.startswith("peak_reserved_bytes")}})
    # Phase 17's cycles beside phase 12's service_100k, the same jobs and
    # nodes fed straight into the service with fake executors.
    emit({"phase": "wire_beside_service_100k",
          "wire_cycle_s": [c["cuda"]["cycle_s"] for c in wire["cycles"]],
          "service_100k_cycle_s": [c["cycle_s"] for c in service["service_100k"]["cuda"]["cycles"]]})

    def launch_sum(records, name):
        return int(sum(r.get("cuda_cold_launches", r.get("launches", {})).get(name, 0)
                       for r in records))

    policy_runs = [r for k, r in policies.items() if not k.endswith("_2x2")]
    market_2x2 = [r for k, r in market.items() if k.endswith("_2x2")]
    market_single = [r for k, r in market.items() if not k.endswith("_2x2")]

    launches = dict(sharded["gangs_100k"]["launches"])
    launches["ring_exchange"] = timing["ring_exchange"]["launches"]
    mp_launches = multiproc["gangs_100k_2x2"]["launches"]
    replaces = {
        "score_nodes": "armada_tpu/ops/pallas_kernels.py:225 (_score_kernel; body _score_values :156, pallas_call :344)",
        "fill_take": "armada_tpu/ops/pallas_kernels.py:378 (fill_take)",
        "winner_reduce": "armada_tpu/ops/pallas_kernels.py:439 (_winner_kernel via winner_reduce :463, pallas_call :494)",
        "ring_exchange": "armada_tpu/ops/pallas_kernels.py:521 (ring_winner_exchange, loop :532-563, pallas_call :566)",
        "segment_add": "armada_tpu/solver/kernel.py:1506 (jax.ops.segment_sum, an XLA scatter-add, "
                       "not a Pallas kernel; also :1113, :1782, :1791, :1965, solver/dist.py:168, :262)",
    }
    entries = []
    for name in K.KERNELS:
        tm = timing[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"armada_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": int(launches[name]),
            "launches_sharded_round_25k": int(sharded["round_25k"]["launches"][name]),
            "launches_fast_fill_flagship": int(fast["flagship_fast"]["cuda_cold_launches"][name]),
            "launches_round_100k_fast": int(fast["round_100k_fast"]["cuda_cold_launches"][name]),
            "launches_home_away_2x2": int(fast["home_away_2x2"]["launches"][name]),
            "launches_sharded_flagship_fast": int(sharded["flagship_fast"]["launches"][name]),
            "launches_flagship_window": int(driver["flagship_window"]["launches"][name]),
            "launches_flagship_fast_window": int(driver["flagship_fast_window"]["launches"][name]),
            "launches_round_25k_budget": int(driver["round_25k_budget_cuda"]["launches"][name]),
            "launches_flagship_budget": int(driver["flagship_budget"]["launches"][name]),
            "launches_home_away_window": int(driver["home_away_window"]["launches"][name]),
            "launches_flagship": int(flag["cuda_cold_launches"].get(name, 0)),
            "launches_round_100k": int(res["cuda_cold_launches"].get(name, 0)),
            "launches_multiproc_gangs_100k": int(mp_launches.get(name, 0)),
            "launches_policy_runs": launch_sum(policy_runs, name),
            "launches_flagship_fast_priority_2x2": launch_sum(
                [policies["flagship_fast_priority_2x2"]], name),
            "launches_market_single_device": launch_sum(market_single, name),
            "launches_market_2x2": launch_sum(market_2x2, name),
            "launches_warm_cycles": warm["launches_warm_cycles"][name],
            "launches_service_100k": int(service["service_100k"]["cuda"]["launches"][name]),
            "launches_service_flagship": int(service["service_flagship"]["launches"][name]),
            "launches_sim_kernel": int(service["sim_differential"]["kernel"]["launches"][name]),
            "launches_observatory": int(observatory["launches"][name]),
            "launches_autotune_whatif": int(autotune_whatif["launches"][name]),
            "launches_persistence": int(persistence["launches"][name]),
            "launches_lookout": int(lookout["launches"][name]),
            "launches_wire": int(wire["launches"][name]),
            "launches_clients": int(clients["launches"][name]),
            "launches_conformance": int(conformance["launches"][name]),
            "max_abs_err": tm["max_abs_err"],
            "equal": tm["max_abs_err"] == 0,
            "ms": tm["ms"],
            "kernel_ms": tm["ms"],
            "device_ms": tm["device_ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"],
            "bound_by": "bytes",
            "library_ms": tm["library_ms"],
            "shape": tm["shape"],
            **({"gather_reduce_ms": tm["gather_reduce_ms"], "ms_n2": tm["ms_n2"],
                "device_ms_n2": tm["device_ms_n2"]}
               if name == "ring_exchange" else {}),
            **({"floor_device_ms": floor_ms} if name in ("winner_reduce", "ring_exchange") else {}),
            **({"ms_at_b4096": tm["at_b4096"]["ms"],
                "device_ms_at_b4096": tm["at_b4096"]["device_ms"],
                "sort_device_ms_at_b4096": tm["at_b4096"]["sort_device_ms"],
                "plain_ms_at_b4096": tm["at_b4096"]["plain_ms"],
                "bound_ms_at_b4096": tm["at_b4096"]["bound_ms"],
                "library_ms_at_b4096": tm["at_b4096"]["library_ms"]}
               if name == "fill_take" else {}),
            **({"cluster": tm["cluster"], "ms_at_8192": tm["ms_at_8192"],
                "device_ms_at_8192": tm["at_8192"]["device_ms"],
                "library_ms_at_8192": tm["at_8192"]["library_ms"],
                "plain_ms_at_8192": tm["at_8192"]["plain_ms"],
                "bound_ms_at_8192": tm["at_8192"]["bound_ms"],
                "ms_score_keys": tm["ms_score_keys"]}
               if name == "fill_take" else {}),
            **({"plan_ms": tm["plan_ms"], "plan_device_ms": tm["plan_device_ms"]}
               if name == "score_nodes" else {}),
            **({"kernel_device_ms": tm["kernel_device_ms"], "bound_share": tm["bound_share"],
                "cases": tm["cases"]} if name == "segment_add" else {}),
        })
    emit({"kernels": entries})
    emit({"ptxas": ptxas})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(segment_library() if sys.argv[1:] == ["--segment-library"] else main())
