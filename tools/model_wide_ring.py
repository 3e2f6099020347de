"""A model of ``fa2_fwd_wide_kernel``'s K/V ring: the producer warp, the two
consumer warpgroups, their full/empty mbarriers with parity waits, and TMA
loads that land in any order, run under random interleavings. It checks
that every consumer reads the record and the K/V tiles of its own position,
that no load overwrites a tile under a read, and that every walk ends.

    python tools/model_wide_ring.py [--walks N]

Prints, for each ring (tile mode, stages, barrier slots), how many of N
random walks broke. One barrier slot a stage breaks the one-q-tile mode's
3-stage ring (a warpgroup's parity wait passes on a slot a phase behind);
two slots a stage, as the kernel has, do not. Needs no card.
"""

from __future__ import annotations

import argparse
import random


class Barrier:
    """An mbarrier: arrivals and transaction bytes complete a phase."""

    def __init__(self, count: int):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self, n: int = 1):
        self.pending -= n
        if self.pending < 0:
            raise RuntimeError("more arrivals than the phase expects")
        self._complete()

    def expect(self, nbytes: int):
        self.tx += nbytes

    def land(self, nbytes: int):
        self.tx -= nbytes
        self._complete()

    def passed(self, parity: int) -> bool:  # mbarrier.try_wait.parity
        return (self.phase & 1) != parity


def walk(takers, single: bool, nst: int, nb: int, seed: int) -> str | None:
    """One walk of len(takers) positions (takers[p]: the warpgroups whose q
    tile takes position p); None if it ran clean, else what broke."""
    rnd = random.Random(seed)
    users = 1 if single else 2  # a warpgroup's 128 arrivals count as one
    k_full, k_empty = [Barrier(1) for _ in range(nb)], [Barrier(users) for _ in range(nb)]
    v_full, v_empty = [Barrier(1) for _ in range(nb)], [Barrier(users) for _ in range(nb)]
    q_bar = Barrier(1)
    K, V, rec = [None] * nst, [None] * nst, [None] * nst
    loads, errors, reading = [], [], {}

    def load(tiles, kind, s, pos, bar):
        if reading.get((kind, s)):
            errors.append(f"{kind} load of position {pos} under a read")
        tiles[s] = (pos, False)

        def landed():
            tiles[s] = (pos, True)
            bar.land(1)
        loads.append(landed)

    def back(b, ph):  # slot and phase of the stage's previous user, nst positions before
        if nb == nst:
            return b, ph ^ 1
        return (b - nst, ph) if b >= nst else (b + nst, ph ^ 1)

    n = len(takers)

    def producer():
        q_bar.expect(1)
        q_bar.arrive()
        loads.append(lambda: q_bar.land(1))
        b, ph, p = 0, 0, 0
        rec[nst - 1] = (-1, set(), -1)
        while True:
            s = b % nst
            eb, eph = back(b, ph)
            while not k_empty[eb].passed(eph):
                yield
            j, tk = (p, takers[p]) if p < n else (-1, set())
            if j >= 0:
                k_full[b].expect(1)
                load(K, "K", s, j, k_full[b])
            rec[s] = (j, tk, p)
            k_full[b].arrive()
            yield
            vb, vph = (nb - 1, ph ^ 1) if b == 0 else (b - 1, ph)
            px, ptk, _ = rec[vb % nst]
            if px >= 0:
                eb, eph = back(vb, vph)
                while not v_empty[eb].passed(eph):
                    yield
                skip = 0 if single else 2 - len(ptk)
                if skip < 2:
                    v_full[vb].expect(1)
                    v_full[vb].arrive()
                    load(V, "V", vb % nst, px, v_full[vb])
                else:
                    v_full[vb].arrive()
                if skip:
                    v_empty[vb].arrive(skip)
                yield
            b, p = b + 1, p + 1
            if b == nb:
                b, ph = 0, ph ^ 1
            if j < 0:
                break
        if single:  # the second end record
            eb, eph = back(b, ph)
            while not k_empty[eb].passed(eph):
                yield
            rec[b % nst] = (-1, set(), p)
            k_full[b].arrive()

    def consumer(w):
        stride = 2 if single else 1
        b, ph, mine = (w, 0, w) if single else (0, 0, 0)
        pend = None  # (slot, phase, position) of the pending P V

        def finish_pv():
            pb, pph, pos = pend
            while not v_full[pb].passed(pph):
                yield
            if V[pb % nst] != (pos, True):
                errors.append(f"warpgroup {w}: P V of position {pos} read {V[pb % nst]}")
            v_empty[pb].arrive()

        while not q_bar.passed(0):
            yield
        while True:
            s = b % nst
            while not k_full[b].passed(ph):
                yield
            j, tk, pos = rec[s]
            if pos != mine:
                errors.append(f"warpgroup {w} read the record of position {pos} at {mine}")
                return
            if j < 0:
                break
            if w not in tk:
                if pend is not None:
                    yield from finish_pv()
                    pend = None
                k_empty[b].arrive()
            else:
                if K[s] != (j, True):
                    errors.append(f"warpgroup {w}: S of position {j} read {K[s]}")
                reading.setdefault(("K", s), set()).add(w)
                yield
                if pend is not None:
                    yield from finish_pv()
                reading[("K", s)].discard(w)
                k_empty[b].arrive()
                pend = (b, ph, j)
            yield
            b, mine = b + stride, mine + stride
            if b >= nb:
                b, ph = b - nb, ph ^ 1
        if pend is not None:
            yield from finish_pv()

    actors = [producer(), consumer(0), consumer(1)]
    alive = [True] * 3
    for _ in range(400_000):
        if not any(alive) and not loads:
            return None
        pick = rnd.choice([i for i in range(3) if alive[i]] + (["load"] if loads else []))
        try:
            if pick == "load":
                loads.pop(rnd.randrange(len(loads)))()
            else:
                next(actors[pick])
        except StopIteration:
            alive[pick] = False
        except RuntimeError as e:
            return str(e)
        if errors:
            return errors[0]
    return "no end (a hang)"


def random_takers(seed: int, single: bool) -> list:
    """A walk of up to 29 positions: dealt in turn (one q tile a CTA), or
    (pair mode) taken by either tile, both or, under DENSE, neither."""
    rnd = random.Random(seed)
    n = rnd.randrange(0, 30)
    if single:
        return [{p % 2} for p in range(n)]
    return [rnd.choice([{0}, {1}, {0, 1}, set()]) if rnd.random() < 0.5 else {0, 1}
            for _ in range(n)]


def broken_walks(single: bool, nst: int, nb: int, walks: int):
    """(how many of ``walks`` random walks broke, what broke first)."""
    broke, first = 0, None
    for t in range(walks):
        what = walk(random_takers(t, single), single, nst, nb, t)
        if what:
            broke += 1
            first = first or what
    return broke, first


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walks", type=int, default=2000)
    args = ap.parse_args()
    rings = [(True, 3, 3), (True, 3, 6), (True, 4, 4), (False, 2, 2), (False, 4, 4)]
    for single, nst, nb in rings:
        broke, first = broken_walks(single, nst, nb, args.walks)
        mode = "one q tile" if single else "pair"
        print(f"{mode}, {nst} stages, {nb} barrier slots: {broke} of {args.walks} walks broke"
              + (f" (first: {first})" if first else ""))


if __name__ == "__main__":
    main()
