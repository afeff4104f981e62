"""RoleMaker — cluster role discovery from env vars or user config
(counterpart of paddle_tpu/distributed/fleet/role_maker.py).

Reference: python/paddle/distributed/fleet/base/role_maker.py
(PaddleCloudRoleMaker reads PADDLE_* env; UserDefinedRoleMaker for
explicit construction). Used by fleet to decide whether this process is
a trainer (worker) or a parameter server (whose runtime a later slice
brings).
"""
import os


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_num = 1
        self._server_endpoints = []
        self._worker_endpoints = []
        self._is_collective = False

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return self._worker_num

    def server_num(self):
        return len(self._server_endpoints)

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)

    def get_trainer_endpoints(self):
        return list(self._worker_endpoints)


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-var cluster discovery (reference role_maker.py PaddleCloud
    convention: TRAINING_ROLE, PADDLE_PSERVERS_IP_PORT_LIST,
    PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ID, PADDLE_PORT)."""

    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        if is_collective:
            return
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._server_endpoints = [
            e for e in os.environ.get(
                "PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e]
        self._worker_endpoints = [
            e for e in os.environ.get(
                "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
        self._worker_num = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        if role == "PSERVER":
            self._role = Role.SERVER
            ip = os.environ.get("POD_IP", "127.0.0.1")
            port = os.environ.get("PADDLE_PORT", "0")
            me = f"{ip}:{port}"
            self._current_id = self._server_endpoints.index(me) \
                if me in self._server_endpoints else 0
        else:
            self._role = Role.WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))


class UserDefinedRoleMaker(RoleMakerBase):
    """Explicit construction (reference role_maker.py UserDefinedRoleMaker)."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, worker_endpoints=None,
                 is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = bool(is_collective)
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = list(server_endpoints or [])
        self._worker_endpoints = list(worker_endpoints or [])
