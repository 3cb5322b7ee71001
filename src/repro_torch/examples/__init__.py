"""The port's counterparts of the repository's ``examples/`` scripts.

Each module runs as ``python -m repro_torch.examples.<name>`` on the CUDA
device unless the caller asks for the CPU (``--device cpu``, or
``device="cpu"`` to its ``run``). In each, as in
``repro_torch.launch.serve_trace``, ``run(...)`` does the work and returns
the numbers it prints, and ``main(argv)`` parses the command line, calls
it and returns 0:

- ``quickstart`` — one `OffloadConfig`, one session: training with
  activation and moment offload, then resident and ``kv_offload``
  generation, which must agree;
- ``serve_offload`` — a paged KV cache in the host tier with top-k page
  selection and the fused paged decode, or (``--continuous``) the
  continuous-batching scheduler;
- ``schedule_viz`` — ASCII timelines of the planner's three orders (the
  paper's Figs. 3–4), modelled for the port's ``H100`` spec;
- ``train_100m`` — a ~100M-parameter phi3-family model trained with
  checkpoints and a resume check.
"""
