"""Training of the port: losses, optimizer and schedule, the train step, the trainer."""
