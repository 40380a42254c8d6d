"""The paper's evaluation platform: an optimistic (Time Warp) discrete-event
simulator with periodic game-theoretic repartitioning, machine-speed churn
scenarios and the flooded packet-flow workload (PyTorch port of
``repro.des``)."""
from .engine import (  # noqa: F401
    NORMAL,
    ROLLBACK,
    DESConfig,
    DESState,
    des_tick,
    make_initial_state,
    run_simulation,
    run_simulation_batch,
)
from .scenarios import (  # noqa: F401
    SpeedSchedule,
    constant,
    failure_recovery,
    make_schedule,
    pad_segments,
    random_churn,
    slowdown,
    speeds_at,
    stack_schedules,
)
from .workload import ThreadSpec, flooded_packet_workload  # noqa: F401
