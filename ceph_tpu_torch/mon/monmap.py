"""MonMap — the static monitor roster (src/mon/MonMap.h).

Ranks are assigned by sorted address order exactly like the reference
(calc_ranks); the map rarely changes, so it is plain config here rather than
a Paxos-managed map.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class MonMap:
    addrs: dict[str, str] = field(default_factory=dict)  # name -> host:port

    @property
    def ranks(self) -> list[str]:
        """Names ordered by rank (sorted by address, MonMap::calc_ranks)."""
        return [name for _addr, name in sorted((a, n) for n, a in self.addrs.items())]

    def rank_of(self, name: str) -> int:
        return self.ranks.index(name)

    def addr_of_rank(self, rank: int) -> str:
        return self.addrs[self.ranks[rank]]

    def size(self) -> int:
        return len(self.addrs)

    def quorum_size(self) -> int:
        return self.size() // 2 + 1
