"""Operational helper tools, each run as `python -m
karpenter_tpu_torch.tools.<name>`: trace_demo (the tracing and incident
walkthrough), certify (cost bounds), graftlint (static analysis), simcheck
(scenario validation), gendocs (the instance-types page),
allocatable_diff (the overhead model against observed allocatable) and
convert (legacy manifests)."""
