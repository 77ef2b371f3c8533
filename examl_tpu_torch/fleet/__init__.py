"""examl_tpu_torch.fleet — many-tree batched evaluation and the job-queue
driver behind the CLI's `-b K`, `-N K` and `--serve` (the port of
`examl_tpu/fleet/`, in one process, over one lane or several).

ExaML users run fleets of independent analyses — bootstrap replicates,
multi-start searches, per-gene trees — and a small analysis alone fills
little of a wide card.  Pieces:

* `seeds`      — splitmix64 per-job seed derivation (`-p`-stable across
                 restarts);
* `bootstrap`  — site-multiplicity weight resampling and its packed
                 layout;
* `batch`      — the batched evaluation tier: J tree jobs through ONE
                 launch table of kernel B1 over a stacked arena
                 (`fastpath.stack_tables`), any mix of topologies; PSR
                 jobs on the wave-scan tier one after another; bootstrap
                 replicates as one CLV pass and one batched root
                 reduction; batched gradient smoothing for
                 `--fleet-cycles`;
* `jobs`       — job specs and the JSONL jobs-file format (admission
                 schema included);
* `shard`      — the tree axis: a lane per device (`DeviceShard`,
                 `ShardSet`) and the `1xT` fabric's tree slices
                 (`MeshShard`);
* `driver`     — the grouped work queue with per-job checkpoints and
                 `-R` resume, one round of batches over the lanes;
* `quarantine` — job-level fault domains: poison-job bisection, the
                 per-job retry ladder, dead letters, the fsync'd results
                 journal with journal ∪ checkpoint resume, and `--serve`
                 admission checks.  A fault of a kernel or of the card is
                 never a job's.
"""
