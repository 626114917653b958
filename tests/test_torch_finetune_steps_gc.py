"""The graph-classification families (PTC_MR binary, ENZYMES multiclass with
its frozen encoder) through the step tests of test_torch_finetune_steps.py:
the same tests, fixtures and tolerances, in a file of its own so that the JAX
compiles of the eight cases spread over two test workers.
"""

from test_torch_finetune_steps import (  # noqa: F401  (collected from here)
    case_fixture,
    small_model_without_dropout,
    processed_dir,
    test_batch_norm_statistics_after_one_train_step,
    test_eval_step_after_training,
    test_gradients_of_one_train_step,
    test_loss_gnorm_and_outputs_of_one_train_step,
    test_parameters_after_two_steps,
)

case = case_fixture(("PTC_MR", "ENZYMES"))
