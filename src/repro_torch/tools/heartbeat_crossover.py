"""Paper §4.1 footnote 6: the control-plane message-rate crossover.

LARK's full-mesh heartbeats n(n-1) against quorum-log's per-partition
heartbeats P*RF*(RF-1); for P = 4096, RF = 3 the curves cross at
n ~ sqrt(6P) ~ 157.  Standard library only.

    python -m repro_torch.tools.heartbeat_crossover
"""
from __future__ import annotations

import math
import sys


def lark_heartbeats(n: int) -> int:
    return n * (n - 1)


def quorum_heartbeats(P: int = 4096, rf: int = 3) -> int:
    return P * rf * (rf - 1)


def crossover(P: int = 4096, rf: int = 3) -> float:
    return math.sqrt(P * rf * (rf - 1))


def line(P: int = 4096, rf: int = 3) -> str:
    """The tool's one CSV line."""
    n_star = crossover(P, rf)
    below = lark_heartbeats(150) < quorum_heartbeats(P, rf)
    above = lark_heartbeats(165) > quorum_heartbeats(P, rf)
    return (f"heartbeat_crossover,n_star,0,"
            f"n={n_star:.1f};paper=156.8;below150={below};above165={above}")


def cli_options() -> tuple:
    """No flags of its own."""
    return ()


def main(argv=None, *, strict: bool = True) -> int:
    extra = sys.argv[1:] if argv is None else list(argv)
    if strict and extra:
        print(f"python -m repro_torch.tools.heartbeat_crossover: error: "
              f"unrecognized arguments: {' '.join(extra)}", file=sys.stderr)
        raise SystemExit(2)
    print(line())
    if abs(crossover() - 156.76) >= 0.5:
        raise AssertionError("the crossover moved off the paper's ~157")
    return 0


if __name__ == "__main__":
    sys.exit(main())
