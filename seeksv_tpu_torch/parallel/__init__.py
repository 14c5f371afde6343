"""The distributed half of the port on torch.distributed (counterpart of
``seeksv_tpu/parallel/``): ``mesh`` (make_mesh, the collectives helpers,
process_allgather), ``spmd_pipeline`` (spmd_run_pipeline,
multiprocess_coverage_insert), ``stream_spmd``
(spmd_run_pipeline_streaming), ``multiproc`` (multiprocess_run_pipeline,
multiprocess_somatic_range, multiprocess_somatic: each rank decodes only
its own part of the BAM), ``sharded`` (sharded_evidence_step,
make_example_batch), ``sharded_getclip`` (getclip_sharded, host only),
``dryrun`` (dryrun_multichip).  Import the submodules directly; this
package imports nothing at import time."""
