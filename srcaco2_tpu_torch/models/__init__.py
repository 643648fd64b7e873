"""Networks (torch.nn) of the port."""
