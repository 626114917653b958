"""Fine-tuning: per-task-family train/eval steps, mining, metrics, host loop."""
