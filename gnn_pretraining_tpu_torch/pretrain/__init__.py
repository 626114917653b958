"""Multi-task pretraining (the JAX package's ``pretrain/``)."""
