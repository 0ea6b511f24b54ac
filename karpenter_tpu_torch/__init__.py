"""karpenter_tpu_torch — the PyTorch + CUDA port of karpenter_tpu.

The same node-provisioning solver as the JAX package, with its device
programs rewritten as hand-written CUDA kernels for the NVIDIA H100
(`sm_90a`).  Layout and names follow `karpenter_tpu`, so every module has a
counterpart there:

  api/        Pod / Node / NodePool data model (host copies)
  catalog/    instance types, offerings, the synthetic catalog generator
  ops/        tensorize → class-granular and pod-granular pack, the LP guide
              (CUDA kernels) → host or slab decode; the solver ladders
  state/      the cluster snapshot (nodes, pods, bindings, PDBs), its
              persistent delta arena's ingestion batcher
  cloud/      the fake cloud and its services, the request batcher, the ICE
              cache, the CloudProvider seam
  providers/  subnets, security groups, instance profiles, versions, images,
              launch templates, pricing
  controllers/  provisioning, disruption, termination, the node lifecycle,
              interruption, garbage collection, NodeClass
  operator/   options, the Operator's provider graph, build_controllers,
              the controller manager and its endpoints
  obs/        the incident bus, the flight recorder, the SLO engine and
              the cost ledger (host work over the metric registry)
  tools/      trace_demo, the tracing and incident walkthrough
  csrc/       the CUDA sources, built with nvcc at first use (_build.py)
  convert.py  builds port objects from the reference's numpy arrays
  workloads.py  seeded pod batches, plan fingerprints and goldens

The package imports torch and numpy only; it never imports jax or the JAX
package.
"""

__version__ = "0.1.0"
