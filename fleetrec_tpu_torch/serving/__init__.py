from .compose import ServeSpec, build_engine, serve
from .engine import LatencyStats, ServingEngine
from .ingest import IngestServer, Loadgen, ScatterEgress, build_native
from .wire import IndexWireFormat

__all__ = ["IngestServer", "Loadgen", "ScatterEgress", "build_native",
           "ServingEngine", "LatencyStats", "IndexWireFormat", "ServeSpec",
           "build_engine", "serve"]
