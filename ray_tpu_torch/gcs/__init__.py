"""The GCS of the port: table storage, pubsub, the server with its node,
heartbeat, resource, job, KV and worker managers, the task-event
pipeline and job graph, and the placement-group manager."""
