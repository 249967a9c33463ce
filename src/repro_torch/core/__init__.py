"""Host-side telemetry shared by the adaptation and serving engines."""
