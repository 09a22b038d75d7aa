"""The autoscaler of the port: the demand solve in pack mode."""
