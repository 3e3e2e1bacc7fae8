"""Observability and debugging helpers: telemetry tables (``info``), the
2-D MLL contour (``lkd_contour``) and a finite-difference gradient check
(``gradcheck``)."""
