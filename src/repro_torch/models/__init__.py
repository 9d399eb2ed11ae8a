"""The model zoo of the port: the ssm family (mamba2) so far."""
