"""The single-graph cells (Cora_NC, CiteSeer_LP) through the whole-slice tests
of test_torch_finetune_loop.py: the same tests and fixtures, in a file of its
own so that the two packages' runs spread over two test workers.
"""

from test_torch_finetune_loop import (  # noqa: F401  (collected from here)
    CELLS,
    processed_dir,
    run_fixture,
    test_metric_keys_and_parameter_counts_equal_jax,
    test_port_checkpoint_reproduces_eval_logits_in_the_jax_model,
    test_selection_patience_and_best_reload,
)

run = run_fixture([CELLS[1], CELLS[2]])
