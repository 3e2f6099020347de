"""A model of the head_dim-64 fused backward's dQ hand-over
(``csrc/flash_bwd.cu`` ``kv_stationary<64, true, ...>``): the two consumer
warpgroups, each owning one kv tile of the CTA's pair, write their halves
of a step's dS^T into one of the alternating dS^T buffers; warpgroup
``n_dq % 2`` waits at a named barrier (``bar.sync``) for the other's
arrival (``bar.arrive``), multiplies the whole 128-row buffer by K and
stages the f32 result in the next buffer of its staging ring, whose writer
warp adds it into dq and frees it (full/empty mbarriers with parity
waits). Runs under random interleavings and checks that every dQ product
reads both halves of its own step, that no half is written while a
product reads it, that each writer reads its own warpgroup's staged steps
in order and that no staging is refilled under a read, and that every walk
ends.

    python tools/model_bwd64_dq.py [--walks N]

Prints, for each protocol (named barriers, dS^T buffers, staging buffers
a warpgroup), how many of N random walks broke. The kernel's protocol (a
barrier a turn, two buffers) does not break; one barrier for both turns
(an arrival completes the other turn's phase) or one dS^T buffer (the
other warpgroup overwrites the half under the product) does. Needs no card.
"""

from __future__ import annotations

import argparse
import random


class Barrier:
    """An mbarrier: ``count`` arrivals complete a phase."""

    def __init__(self, count: int):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self):
        self.pending -= 1
        if self.pending == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity: int) -> bool:  # mbarrier.try_wait.parity
        return (self.phase & 1) != parity


class Named:
    """A named barrier of two warpgroups (each warpgroup's 128 threads count
    as one): bar.arrive and bar.sync both count; the second completes the
    phase and releases whoever waits in it."""

    def __init__(self):
        self.arrived, self.phase = 0, 0

    def arrive(self) -> int:
        self.arrived += 1
        if self.arrived == 2:
            self.arrived, self.phase = 0, self.phase + 1
        return self.phase


def walk(takers, n_bar: int, n_ds: int, n_stg: int, seed: int) -> str | None:
    """One walk of len(takers) steps (takers[m]: the warpgroups whose kv tile
    takes step m; none: a dense step hidden from both, which has no dQ);
    None if it ran clean, else what broke."""
    rnd = random.Random(seed)
    bars = [Named() for _ in range(n_bar)]
    ds = [[None, None] for _ in range(n_ds)]  # the step each half holds
    reading_ds = [0] * n_ds
    stg = [[None] * n_stg for _ in range(2)]
    reading_stg = [[False] * n_stg for _ in range(2)]
    full = [[Barrier(1) for _ in range(n_stg)] for _ in range(2)]
    empty = [[Barrier(1) for _ in range(n_stg)] for _ in range(2)]
    errors = []
    dq_steps = [m for m, tk in enumerate(takers) if tk]
    mine_dq = [[m for i, m in enumerate(dq_steps) if i % 2 == w] for w in range(2)]

    def consumer(w):
        n_dq = n_st = 0
        for m, tk in enumerate(takers):
            if w in tk:
                yield  # S^T, dP^T, dV, dK
            if not tk:
                continue
            buf = n_dq % n_ds
            if reading_ds[buf]:
                errors.append(f"warpgroup {w} wrote its dS half of step {m} under a dQ read")
                return
            ds[buf][w] = m
            yield
            who = n_dq % 2
            bar = bars[(1 + who) % n_bar]
            if who != w:
                bar.arrive()
            else:
                ph = bar.arrive()
                if bar.arrived:  # not the second: wait for the phase to complete
                    while bar.phase == ph:
                        yield
                reading_ds[buf] += 1
                for _ in range(2):
                    if ds[buf] != [m, m]:
                        errors.append(f"warpgroup {w}: dQ of step {m} read halves {ds[buf]}")
                        return
                    yield
                reading_ds[buf] -= 1
                s = n_st % n_stg
                while not empty[w][s].passed(((n_st // n_stg) & 1) ^ 1):
                    yield
                if reading_stg[w][s]:
                    errors.append(f"warpgroup {w} staged step {m} under the writer's read")
                    return
                stg[w][s] = m
                yield
                full[w][s].arrive()
                n_st += 1
            n_dq += 1
        s = n_st % n_stg  # the end record
        while not empty[w][s].passed(((n_st // n_stg) & 1) ^ 1):
            yield
        stg[w][s] = -1
        full[w][s].arrive()

    def writer(w):
        for u in range(len(mine_dq[w]) + 1):
            s = u % n_stg
            while not full[w][s].passed((u // n_stg) & 1):
                yield
            want = mine_dq[w][u] if u < len(mine_dq[w]) else -1
            if stg[w][s] != want:
                errors.append(f"writer {w} read step {stg[w][s]} where step {want} was due")
                return
            if want < 0:
                return
            reading_stg[w][s] = True
            yield  # the bulk reductions read the staging
            reading_stg[w][s] = False
            empty[w][s].arrive()

    actors = [consumer(0), consumer(1), writer(0), writer(1)]
    alive = [True] * 4
    for _ in range(200_000):
        if not any(alive):
            return None
        pick = rnd.choice([i for i in range(4) if alive[i]])
        try:
            next(actors[pick])
        except StopIteration:
            alive[pick] = False
        if errors:
            return errors[0]
    return "no end (a hang)"


def random_takers(seed: int) -> list:
    """A walk of up to 29 steps, each taken by either kv tile of the pair,
    both or, under DENSE, neither."""
    rnd = random.Random(seed)
    return [rnd.choice([{0}, {1}, {0, 1}, set()]) if rnd.random() < 0.5 else {0, 1}
            for _ in range(rnd.randrange(0, 30))]


def broken_walks(n_bar: int, n_ds: int, n_stg: int, walks: int):
    """(how many of ``walks`` random walks broke, what broke first)."""
    broke, first = 0, None
    for t in range(walks):
        what = walk(random_takers(t), n_bar, n_ds, n_stg, t)
        if what:
            broke += 1
            first = first or what
    return broke, first


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walks", type=int, default=2000)
    args = ap.parse_args()
    for n_bar, n_ds, n_stg in ((2, 2, 2), (2, 2, 1), (1, 2, 2), (2, 1, 2)):
        broke, first = broken_walks(n_bar, n_ds, n_stg, args.walks)
        print(f"{n_bar} named barriers, {n_ds} dS^T buffers, {n_stg} staging buffers a "
              f"warpgroup: {broke} of {args.walks} walks broke"
              + (f" (first: {first})" if first else ""))


if __name__ == "__main__":
    main()
