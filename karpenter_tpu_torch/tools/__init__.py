"""Operational helper tools (`python -m karpenter_tpu_torch.tools.trace_demo`)."""
