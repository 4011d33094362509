"""Multi-channel connection management (§6.1 "Multi-channel optimization").

A Channel is one QP (+ its own CQ unless shared-CQ mode) to one remote
node, living in a dedicated context to avoid the false synchronization of
shared QPs. ``K`` channels per remote node engage multiple NIC PUs; the
paper finds K=4 optimal on their hardware (Fig. 11).
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional

from .completion import CompletionQueue
from .nic import QueuePair, SimulatedNIC

_cq_ids = itertools.count(1)


class Channel:
    def __init__(self, nic: SimulatedNIC, dest_node: int,
                 cq: Optional[CompletionQueue] = None) -> None:
        self.dest_node = dest_node
        self.cq = cq if cq is not None else CompletionQueue(cq_id=next(_cq_ids))
        self.qp: QueuePair = nic.create_qp(dest_node, self.cq)
        self.nic = nic

    @property
    def link(self):
        """The fabric link this channel's QP is bound to (None when the
        NIC is standalone)."""
        return self.qp.link

    def post(self, descs, doorbell: bool = False) -> None:
        self.nic.post(self.qp, descs, doorbell=doorbell)


class ChannelSet:
    """K channels per peer; round-robin selection per destination."""

    def __init__(self, nic: SimulatedNIC, peers: List[int],
                 channels_per_peer: int = 4,
                 shared_cqs: int = 0) -> None:
        """``shared_cqs=M`` > 0 switches to the SCQ(M) design: all channels
        share M completion queues instead of one CQ per channel."""
        self.nic = nic
        self.channels: Dict[int, List[Channel]] = {}
        self._rr: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.shared: List[CompletionQueue] = [
            CompletionQueue(cq_id=next(_cq_ids)) for _ in range(shared_cqs)
        ]
        idx = 0
        for peer in peers:
            chans = []
            for _ in range(channels_per_peer):
                cq = self.shared[idx % shared_cqs] if shared_cqs else None
                chans.append(Channel(nic, peer, cq=cq))
                idx += 1
            self.channels[peer] = chans
            self._rr[peer] = 0

    def pick(self, dest_node: int) -> Channel:
        with self._lock:
            chans = self.channels[dest_node]
            i = self._rr[dest_node]
            self._rr[dest_node] = (i + 1) % len(chans)
            return chans[i]

    def all_cqs(self) -> List[CompletionQueue]:
        if self.shared:
            return list(self.shared)
        out, seen = [], set()
        for chans in self.channels.values():
            for ch in chans:
                if id(ch.cq) not in seen:
                    seen.add(id(ch.cq))
                    out.append(ch.cq)
        return out

    def close(self) -> None:
        for cq in self.all_cqs():
            cq.close()
