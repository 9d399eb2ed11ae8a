"""Training control (``elastic.py``): the heartbeat monitor the host
runtime's failure detector uses."""
