"""The one traffic generator: a configuration and a mix, both data files,
and a seed give the backlog and every period's submissions.

Every seed gets the same multiset of job sizes, queues, gang
cardinalities and runtimes in each block (the backlog, then each
period's submissions), in another order: the seed changes which job gets
what, not how much work there is. A block's units (single jobs, and
gangs of each cardinality) take `np.resize(values, units)` of each
list, permuted by the block's own generator, so a block is the same
whichever blocks were made before it.

Jobs are plain rows here (numpy arrays); `specs` turns a block into the
program's JobSpecs. Ids are `job-<seq>` with the sequence number
zero-padded, so that id order is submission order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GI = 1 << 30
ID_DIGITS = 9


def cpu_millis(q: str) -> int:
    """A cpu quantity of whole cores or millicores ("32", "500m")."""
    return int(q[:-1]) if q.endswith("m") else int(q) * 1000


def mem_bytes(q: str) -> int:
    """A memory quantity in Gi, Mi or bytes ("256Gi")."""
    for suffix, unit in (("Gi", GI), ("Mi", 1 << 20)):
        if q.endswith(suffix):
            return int(q[: -len(suffix)]) * unit
    return int(q)


@dataclasses.dataclass
class Block:
    """One submission: jobs `first` .. `first + n - 1`, all submitted in
    cycle `cycle` at virtual time `now`."""

    cycle: int
    now: float
    first: int
    queue: np.ndarray  # int64[n], queue index
    cpu: np.ndarray  # int64[n], whole cores
    runtime: np.ndarray  # int64[n], in schedule periods
    gang_lead: np.ndarray  # int64[n], the gang's first job (its own seq if single)
    gang_card: np.ndarray  # int64[n], 1 for a single job

    @property
    def n(self) -> int:
        return len(self.queue)


class Traffic:
    """The jobs of one run: `block(0)` is the backlog, submitted at time
    0 before the cold cycle; `block(k)` for k >= 1 the jobs submitted in
    cycle k, at time k x the schedule period."""

    def __init__(self, config: dict, mix: dict, seed: int):
        if seed < 0:
            raise ValueError("seed: a whole number >= 0")
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.queues = [f"queue-{q:02d}" for q in range(int(config["queues"]))]
        self.period = float(config["schedule_period_s"])
        self.backlog = int(config["backlog_jobs"])
        self.per_period = int(mix["submit_per_period"])
        self._blocks: dict[int, Block] = {}

    def first_seq(self, k: int) -> int:
        return 0 if k == 0 else self.backlog + (k - 1) * self.per_period

    def block(self, k: int) -> Block:
        b = self._blocks.get(k)
        if b is None:
            b = self._blocks[k] = self._make(k)
        return b

    def _make(self, k: int) -> Block:
        n = self.backlog if k == 0 else self.per_period
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, k]))
        mix = self.mix

        def balanced(values, m):
            return rng.permutation(np.resize(np.asarray(values, dtype=np.int64), m))

        # The block's units: a gang opens at every `every`-th position no
        # gang covers; every other position is a single job.
        every = int(mix.get("gang_every", 0))
        if every:
            cards = balanced(mix["gang_cardinalities"], -(-n // every))
            starts, ucard, i, g = [], [], 0, 0
            while i < n:
                c = 1
                if i % every == 0:
                    c, g = min(int(cards[g]), n - i), g + 1
                starts.append(i)
                ucard.append(c)
                i += c
            starts, ucard = np.array(starts), np.array(ucard)
        else:
            starts, ucard = np.arange(n), np.ones(n, dtype=np.int64)
        # Each unit's queue, size and runtime, balanced within the units
        # of one cardinality; a gang's members share them.
        queue = np.empty(n, dtype=np.int64)
        cpu, runtime = np.empty_like(queue), np.empty_like(queue)
        lead, card = np.empty_like(queue), np.empty_like(queue)
        first = self.first_seq(k)
        lo, hi = mix["runtime_periods"]
        for c in np.unique(ucard):
            s = starts[ucard == c]
            m = len(s)
            pos = (s[:, None] + np.arange(c)[None, :]).reshape(-1)
            for arr, values in ((queue, np.arange(len(self.queues))), (cpu, mix["job_cpu"]),
                                (runtime, np.arange(int(lo), int(hi) + 1))):
                arr[pos] = np.repeat(balanced(values, m), c)
            lead[pos], card[pos] = np.repeat(first + s, c), c
        return Block(k, k * self.period, first, queue, cpu, runtime, lead, card)

    @staticmethod
    def job_id(seq: int) -> str:
        return f"job-{seq:0{ID_DIGITS}d}"

    @staticmethod
    def gang_id(seq: int) -> str:
        return f"gang-{seq:0{ID_DIGITS}d}"

    def specs(self, b: Block) -> dict[str, list]:
        """The block's JobSpecs of the program, by queue name, in id
        order."""
        from armada_tpu_torch.core.types import Gang, JobSpec

        mem_per_cpu = int(self.mix["memory_gi_per_cpu"])
        pc = self.mix["priority_class"]
        # One requests dict a size and one Gang a gang, shared by the jobs
        # that have them (JobSpecs are frozen; the program copies on change).
        requests = {int(c): {"cpu": str(int(c)), "memory": f"{int(c) * mem_per_cpu}Gi"}
                    for c in np.unique(b.cpu)}
        gangs = {int(s): Gang(id=self.gang_id(int(s)), cardinality=int(c))
                 for s, c in zip(b.gang_lead[b.gang_card > 1], b.gang_card[b.gang_card > 1])}
        out: dict[str, list] = {name: [] for name in self.queues}
        names = self.queues
        for i, (q, c, lead) in enumerate(zip(b.queue.tolist(), b.cpu.tolist(), b.gang_lead.tolist())):
            out[names[q]].append(JobSpec(
                id=self.job_id(b.first + i), queue=names[q], priority_class=pc,
                requests=requests[c], gang=gangs.get(lead),
            ))
        return out
