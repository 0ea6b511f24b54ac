"""karpenter_tpu_torch — the PyTorch + CUDA port of karpenter_tpu.

The same node-provisioning solver as the JAX package, with its device
programs rewritten as hand-written CUDA kernels for the NVIDIA H100
(`sm_90a`).  Layout and names follow `karpenter_tpu`, so every module has a
counterpart there:

  api/        Pod / Node / NodePool data model (host copies)
  catalog/    instance types, offerings, the synthetic catalog generator
  ops/        tensorize → class-granular and pod-granular pack, the LP guide
              (CUDA kernels) → host or slab decode; the solver ladders
  state/      the cluster snapshot (nodes, pods, bindings, PDBs)
  cloud/      the fake cloud, the ICE cache, the CloudProvider seam
  controllers/  provisioning, the consolidation decision
  csrc/       the CUDA sources, built with nvcc at first use (_build.py)
  convert.py  builds port objects from the reference's numpy arrays
  workloads.py  seeded pod batches, plan fingerprints and goldens

The package imports torch and numpy only; it never imports jax or the JAX
package.
"""

__version__ = "0.1.0"
