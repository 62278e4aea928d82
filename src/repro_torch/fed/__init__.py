"""Federated simulation: tasks, local training, cohorts and the server loop
(``repro_torch.fed.server.run_federated``)."""
