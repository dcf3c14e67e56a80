"""karpenter_provider_aws_tpu_torch — node provisioning in PyTorch and CUDA.

The second implementation of the node-provisioning framework, beside the JAX
package it is held against. The layout mirrors the JAX package so that each
module's counterpart is found by name:

- ``models/``     — the data model: label requirements, Pod, NodePool,
                    NodeClass, NodeClaim, PDBs.
- ``catalog/``    — the instance-type catalog: capacities, allocatable math,
                    static prices, offerings, ICE masking, market state.
- ``ops/``        — host encode (numpy), the FFD bin-packing step and the
                    consolidation screen: plain PyTorch versions and
                    hand-written CUDA kernels (``csrc/``) for Hopper.
- ``scheduling/`` — ``TorchSolver``: encode, one kernel launch, launch-option
                    ranking, sparse plan fetch, refine and decode; the
                    optimizer lane; ``snapshot_existing_capacity``.
- ``state/``      — the journaled cluster store.
- ``controllers/``, ``cloudprovider/``, ``providers/``, ``fake/``,
  ``events.py``, ``metrics.py``, ``obs/``, ``trace/`` — the provisioning
                    control plane, wired by ``testenv.new_environment()``.
- ``interop.py``  — builds this package's tensors and stores from the JAX
                    package's plain data, for tests that feed both the same
                    inputs.

Entry points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
