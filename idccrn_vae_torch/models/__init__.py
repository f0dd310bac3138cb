"""Model modules of the port, under the reference's state_dict names."""
