"""The SPMD pipeline on a torch.distributed mesh (counterpart of
``seeksv_tpu/parallel/``): ``mesh`` (make_mesh, collectives helpers),
``spmd_pipeline`` (spmd_run_pipeline), ``stream_spmd``
(spmd_run_pipeline_streaming), ``dryrun`` (dryrun_multichip).  Import the
submodules directly; this package imports nothing at import time."""
