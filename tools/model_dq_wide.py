"""A model of the head_dim-256 dQ kernel's hand-over (``csrc/flash_bwd.cu``
``dq_wide``): a producer warp loads K_j into K's ring and hands
over the step's record on K's full barrier, then loads V_j into V's ring
(full/empty mbarriers with parity waits, ``kst`` and ``vst`` stages); the
two consumer warpgroups, which own the same q tile, each wait on every
position of both rings, issue S and dP for their half of the step's kv
columns together with the pending step's
dQ += dS K (both halves of its dS, from its slot, and its K stage), free V
once dP has completed, write their half of the step's bf16 dS into the
step's slot, wait for the pending product, free its K stage, and meet at a
named barrier; a step that the tile does not take (DENSE) finishes the
pending product and frees both stages. The slots alternate with the taken
steps. Runs under random interleavings and checks that every product reads
the tiles and the dS halves of its own step, that nothing is written while
a product reads it, and that every walk ends.

    python tools/model_dq_wide.py [--walks N]

Prints, for each protocol, how many of N random walks broke. The kernel's
protocol (K 3 stages, V 1, two slots; V freed after dP, K after the dQ that
reads it; also with 2 and 2 stages) does not break; one dS slot (a
warpgroup writes the next step's half under the other's pending product)
or V freed when dP is issued rather than completed (the producer refills
the stage under the read) does. Needs no card.
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
    """A named barrier of the two consumer warpgroups (bar.sync): the second
    arrival completes the phase."""

    def __init__(self):
        self.arrived, self.phase = 0, 0

    def arrive(self) -> int:
        self.arrived += 1
        if self.arrived == 2:
            self.arrived, self.phase = 0, self.phase + 1
        return self.phase


def walk(takes, kst: int, vst: int, n_slots: int, v_early: bool, seed: int) -> str | None:
    """One walk of len(takes) positions (takes[n]: the tile takes position
    n; False: a DENSE step hidden from it); None if it ran clean, else what
    broke. ``v_early``: a consumer frees V when it issues dP."""
    rnd = random.Random(seed)
    k_full, k_empty = [Barrier(1) for _ in range(kst)], [Barrier(2) for _ in range(kst)]
    v_full, v_empty = [Barrier(1) for _ in range(vst)], [Barrier(2) for _ in range(vst)]
    k_tile, v_tile = [None] * kst, [None] * vst  # the position each stage holds
    rec = [None] * kst                             # the record of K's stage
    reading_k, reading_v = [0] * kst, [0] * vst
    slot = [[None, None] for _ in range(n_slots)]  # the step each half of a slot holds
    reading_slot = [0] * n_slots
    named = Named()
    errors = []

    def producer():
        n_pos = len(takes)
        for n in range(n_pos + 1):
            ks, vs = n % kst, n % vst
            while not k_empty[ks].passed(((n // kst) & 1) ^ 1):
                yield
            if n == n_pos:  # the end record
                rec[ks] = -1
                k_full[ks].arrive()
                return
            if reading_k[ks]:
                errors.append(f"K stage {ks} refilled with position {n} under a read")
                return
            k_tile[ks] = n
            yield  # K's copy is under way; the classification, then the record
            rec[ks] = n
            k_full[ks].arrive()
            while not v_empty[vs].passed(((n // vst) & 1) ^ 1):
                yield
            if reading_v[vs]:
                errors.append(f"V stage {vs} refilled with position {n} under a read")
                return
            v_tile[vs] = n
            yield
            v_full[vs].arrive()

    def read(kind, idx, want):
        """A product's read of a tile or slot: what it must hold."""
        got = (k_tile if kind == "K" else v_tile)[idx] if kind in "KV" else slot[idx]
        if got != want:
            errors.append(f"a product read {kind} {idx} holding {got}, not {want}")

    def consumer(w):
        pend = None  # (position, K stage, slot) of the step whose dQ is not issued
        n_x = 0
        n = 0
        while True:
            ks, vs = n % kst, n % vst
            while not k_full[ks].passed((n // kst) & 1):
                yield
            if rec[ks] == -1:
                break
            m = rec[ks]
            if m != n:
                errors.append(f"warpgroup {w} took position {m}'s record at position {n}")
                return
            while not v_full[vs].passed((n // vst) & 1):
                yield
            if not takes[n]:
                if pend is not None:  # finish the pending product
                    pm, pk, ps = pend
                    reading_k[pk] += 1
                    reading_slot[ps] += 1
                    for _ in range(2):
                        read("K", pk, pm)
                        read("S", ps, [pm, pm])
                        yield
                    reading_k[pk] -= 1
                    reading_slot[ps] -= 1
                    k_empty[pk].arrive()
                    pend = None
                k_empty[ks].arrive()
                v_empty[vs].arrive()
                n += 1
                continue
            cur = n_x % n_slots
            # S, dP and the pending dQ issued: their reads run until the waits.
            reading_k[ks] += 1
            reading_v[vs] += 1
            if pend is not None:
                pm, pk, ps = pend
                reading_k[pk] += 1
                reading_slot[ps] += 1
            if v_early:
                v_empty[vs].arrive()
            for _ in range(2):
                read("K", ks, n)
                read("V", vs, n)
                if pend is not None:
                    read("K", pk, pm)
                    read("S", ps, [pm, pm])
                yield
            reading_k[ks] -= 1
            reading_v[vs] -= 1  # S and dP complete
            if not v_early:
                v_empty[vs].arrive()
            if reading_slot[cur]:
                errors.append(f"warpgroup {w} wrote its dS half of position {n} under a read")
                return
            slot[cur][w] = n
            yield
            if pend is not None:  # the pending dQ completes
                for _ in range(rnd.randrange(2)):
                    read("K", pk, pm)
                    read("S", ps, [pm, pm])
                    yield
                reading_k[pk] -= 1
                reading_slot[ps] -= 1
                k_empty[pk].arrive()
            ph = named.arrive()
            if named.arrived:  # the first to arrive waits for the phase
                while named.phase == ph:
                    yield
            pend = (n, ks, cur)
            n_x += 1
            n += 1
        if pend is not None:  # the last step's dQ
            pm, pk, ps = pend
            reading_k[pk] += 1
            reading_slot[ps] += 1
            for _ in range(2):
                read("K", pk, pm)
                read("S", ps, [pm, pm])
                yield
            reading_k[pk] -= 1
            reading_slot[ps] -= 1
            k_empty[pk].arrive()

    actors = [producer(), consumer(0), consumer(1)]
    alive = [True] * 3
    for _ in range(200_000):
        if not any(alive):
            return None
        pick = rnd.choice([i for i in range(3) if alive[i]])
        try:
            next(actors[pick])
        except StopIteration:
            alive[pick] = False
        if errors:
            return errors[0]
    return "no end (a hang)"


def random_takes(seed: int) -> list:
    """A walk of up to 29 positions, most taken, some (DENSE) not."""
    rnd = random.Random(seed)
    return [rnd.random() < 0.8 for _ in range(rnd.randrange(0, 30))]


def broken_walks(kst: int, vst: int, n_slots: int, v_early: bool, walks: int):
    """(how many of ``walks`` random walks broke, what broke first)."""
    broke, first = 0, None
    for t in range(walks):
        what = walk(random_takes(t), kst, vst, n_slots, v_early, t)
        if what:
            broke += 1
            first = first or what
    return broke, first


# (K stages, V stages, dS slots, V freed at dP's issue): the kernel's
# protocol first, then the controls.
PROTOCOLS = ((3, 1, 2, False), (2, 2, 2, False), (3, 1, 1, False), (3, 1, 2, True))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walks", type=int, default=2000)
    args = ap.parse_args()
    for kst, vst, n_slots, v_early in PROTOCOLS:
        broke, first = broken_walks(kst, vst, n_slots, v_early, args.walks)
        print(f"K {kst} stages, V {vst}, {n_slots} dS slots, V freed when dP "
              f"{'is issued' if v_early else 'completes'}: {broke} of {args.walks} walks broke"
              + (f" (first: {first})" if first else ""))


if __name__ == "__main__":
    main()
