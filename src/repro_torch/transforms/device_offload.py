"""DeviceOffload — the paper's ``FPGATransformSDFG`` (§3.2.1), for TPU.

Detects all host-memory accesses in the computation states, creates device
(HBM) twins of the containers, inserts a pre-state copying inputs
host->device and a post-state copying outputs device->host, and redirects
every access in the computation states to the device twins.
"""
from __future__ import annotations

from typing import Dict

from ..core.memlet import Memlet
from ..core.sdfg import AccessNode, Array, Scalar, SDFG, State, Stream
from ..core.dtypes import StorageType
from .base import Transformation


class DeviceOffload(Transformation):
    prefix = "dev_"

    def find_matches(self, sdfg: SDFG, **kwargs):
        # one whole-SDFG match if any non-transient host container is
        # accessed in a state (and offload has not run yet)
        if sdfg.metadata.get("device_offloaded"):
            return
        names = set()
        for st in sdfg.states:
            for node in st.data_nodes():
                desc = sdfg.arrays[node.data]
                if (not desc.transient and isinstance(desc, Array)
                        and not isinstance(desc, Stream)
                        and node.data not in sdfg.constants
                        and desc.storage in (StorageType.DEFAULT,
                                             StorageType.HOST)):
                    names.add(node.data)
        if names:
            yield {"names": sorted(names)}

    def apply_match(self, sdfg: SDFG, match: Dict):
        names = match["names"]
        dev_of = {}
        # read-before-write containers need a host->device pre-copy;
        # written containers need a device->host post-copy
        read, written = set(), set()
        for st in (sdfg.state_order() or sdfg.states):
            for node in st.topological_nodes():
                if not isinstance(node, AccessNode) or node.data not in names:
                    continue
                if st.in_degree(node) > 0:
                    written.add(node.data)
                if st.out_degree(node) > 0 and node.data not in written:
                    read.add(node.data)
        for name in names:
            desc = sdfg.arrays[name]
            desc.storage = StorageType.HOST
            dev = self.prefix + name
            sdfg.add_transient(dev, desc.shape, desc.dtype,
                               storage=StorageType.HBM)
            dev_of[name] = dev

        # redirect accesses in computation states
        for st in list(sdfg.states):
            for node in st.data_nodes():
                if node.data in dev_of:
                    new = dev_of[node.data]
                    node.data = new
                    node.label = new
            for e in st.edges:
                if e.memlet.data in dev_of:
                    e.memlet.data = dev_of[e.memlet.data]

        # intermediates point to off-chip memory by default (paper §3.2.3:
        # 'In unoptimized SDFGs, intermediate data is represented as data
        # access nodes, pointing to off-chip memory by default.')
        for name, desc in sdfg.arrays.items():
            if (desc.transient and isinstance(desc, Array)
                    and not isinstance(desc, Stream)
                    and desc.storage is StorageType.DEFAULT):
                desc.storage = StorageType.HBM

        # pre/post copy states (paper Fig. 3 pre_axpy / post_axpy)
        order = sdfg.state_order()
        first, last = order[0], order[-1]
        pre = sdfg.add_state_before(first, "pre_copy_to_device")
        post = sdfg.add_state_after(last, "post_copy_to_host")
        for name in sorted(read):
            h = pre.add_access(name)
            d = pre.add_access(dev_of[name])
            pre.add_edge(h, None, d, None, Memlet.simple(dev_of[name]))
        for name in sorted(written):
            d = post.add_access(dev_of[name])
            h = post.add_access(name)
            post.add_edge(d, None, h, None, Memlet.simple(dev_of[name]))
        sdfg.metadata["device_offloaded"] = True
