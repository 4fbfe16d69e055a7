"""The system's user entry points (counterpart of the reference's
``examples/``), one module each:

* ``geo_cost_planning``  Sailor against DTFM on a five-zone fleet, a
  $/iteration budget sweep and spot-market replans (planner only);
* ``quickstart``         plan ``opt-350m`` on a three-zone fleet for two
  objectives, then execute the plan's pipeline shape on ``MPMDPipeline``;
* ``train_e2e``          a 106M fp32 model through ``ElasticTrainer`` with
  async checkpoints, then a resume from the latest one;
* ``elastic_reconfig``   ``manager.Controller`` over ``ElasticTrainer``
  against a seeded availability trace;
* ``serve_batched``      plan a serving placement under SLOs, then serve
  with ``ContinuousBatchingServer`` at the planned decode batch.

Each runs as ``python -m repro_torch.examples.<name>``; ``main(argv)``
prints the reference script's report lines in its order and returns the
figures it printed.  ``--device`` (all but the planner-only
``geo_cost_planning``) defaults to ``cuda`` (no card: it raises);
``--reduced --device cpu`` runs the reference's own CPU sizes.
Importing a module runs nothing.
"""
