"""Training on one device: the optimizers (``optimizer.py``), the train
step (``train_step.py``), checkpoints (``checkpoint.py``), the data
pipeline (``data.py``) and the elastic control loop (``elastic.py``,
whose heartbeat monitor the host runtime's failure detector also uses).
The launcher is ``python -m repro_torch.launch.train``."""
